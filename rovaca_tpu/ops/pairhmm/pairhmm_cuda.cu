// PairHMM forward on Hopper, called from JAX through the XLA FFI.
//
// Same recurrence as golden.py / xla.py (reference semantics:
// src/haplotypecaller/pairhmm/rovaca/avx_512_float.cc:29-183), laid out after
// gpuPairHMM: one warp scores one (read, haplotype) pair. Each lane owns R
// consecutive read rows and keeps their M/I/D state in registers; the warp
// sweeps haplotype columns as a wavefront skewed by one column per lane, and
// each lane passes its last row's state to the lane below by warp shuffle.
// Reads longer than 32*R rows run in stripes of 32*R rows; a stripe's last
// row goes through shared memory to the next stripe's first lane.
//
// Rows are padded at the top so the read's last row is always the last row
// of some lane. Padding rows stand in for the boundary row (M = I = 0,
// D = 2^120 / hapLen), so they are never updated.
//
// ABI (the scheduler's compact indexed launch, ops/pairhmm/compact.py):
//   q, gi, gc (NR, Lr, 128) u8   base qual / gap-open / gap-continuation phreds
//   rbase     (NR, Lr, 128) i8   bitmask base codes, match test (r & h) != 0
//   rlen      (NR, 1, 128)  i32  0 = padding lane
//   hcode     (NH, Lh, 8)   i8   haplotype base codes
//   hlen      (NH, 8, 1)    i32  0 = padding slot
//   hidx,ridx (G,)          i32  hap tile / read tile of each launch pair
//                                (-1: an unused slot, scored 0)
//   ph2pr     (128,)        f32  phred -> error probability
//   m2m       (128,)        f32  match-to-match probability per gap-open phred
//   out       (G, 8, 128)   f32  raw (2^120-scaled) forward sums
//
// No fast-math: IEEE division for 2^120 / hapLen and no flush of denormals,
// as in the numpy oracle.

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kHapTile = 8;
constexpr int kReadTile = 128;
constexpr int kPairsPerTile = kHapTile * kReadTile;
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
  const uint8_t* q;
  const uint8_t* gi;
  const uint8_t* gc;
  const int8_t* rbase;
  const int32_t* rlen;
  const int8_t* hcode;
  const int32_t* hlen;
  const int32_t* hidx;
  const int32_t* ridx;
  const float* ph2pr;
  const float* m2m;
  float init_const;
  int64_t n_pairs;  // G * 1024
  int NR;           // read tiles
  int NH;           // hap tiles
  int Lr;
  int Lh;
  int hap_bytes;    // per-warp shared bytes for haplotype codes
  int smem_warp;    // per-warp shared bytes in all
};

template <int R>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pairhmm_kernel(Inputs in, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t pair = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (pair >= in.n_pairs) return;
  const int g = (int)(pair / kPairsPerTile);
  const int s = (int)((pair / kReadTile) % kHapTile);
  const int l = (int)(pair % kReadTile);
  const int rt = in.ridx[g];
  const int ht = in.hidx[g];
  // pair slots past a launch's real pairs index tile -1
  const bool valid = rt >= 0 && rt < in.NR && ht >= 0 && ht < in.NH;
  const int rl = valid ? min(in.rlen[rt * kReadTile + l], in.Lr) : 0;
  const int hl = valid ? min(in.hlen[ht * kHapTile + s], in.Lh) : 0;
  if (rl <= 0 || hl <= 0) {
    if (lane == 0) out[pair] = 0.f;
    return;
  }

  unsigned char* wsmem = smem + (size_t)warp * in.smem_warp;
  int8_t* hap = reinterpret_cast<int8_t*>(wsmem);
  float* buf_m = reinterpret_cast<float*>(wsmem + in.hap_bytes);
  float* buf_i = buf_m + in.Lh;
  float* buf_d = buf_i + in.Lh;
  for (int j = lane; j < hl; j += kWarp)
    hap[j] = in.hcode[((int64_t)ht * in.Lh + j) * kHapTile + s];
  __syncwarp();

  const float init_d = in.init_const / (float)hl;
  const int slots = (rl + R - 1) / R;  // lanes needed over all stripes
  const int pad = slots * R - rl;      // boundary rows above row 0
  const int n_stripes = (slots + kWarp - 1) / kWarp;
  const int64_t read_base = (int64_t)rt * in.Lr * kReadTile + l;

  float sum_m = 0.f, sum_i = 0.f;
  for (int st = 0; st < n_stripes; ++st) {
    const int slot = st * kWarp + lane;
    const int n_t = min(kWarp, slots - st * kWarp);
    const bool last_stripe = st == n_stripes - 1;
    const int vpad = slot == 0 ? pad : 0;

    float mm[R], gapm[R], mi[R], ii[R], distm[R], one_distm[R];
    int base[R];
    float M[R], I[R], D[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = slot * R + r - pad;
      const bool real = lane < n_t && row >= 0;
      const int64_t at = read_base + (int64_t)(real ? row : 0) * kReadTile;
      const int qq = real ? (in.q[at] & 127) : 0;
      const int go = real ? (in.gi[at] & 127) : 0;
      const int gcp = real ? (in.gc[at] & 127) : 0;
      const float p_q = in.ph2pr[qq];
      mm[r] = in.m2m[go];
      gapm[r] = 1.f - in.ph2pr[gcp];
      mi[r] = in.ph2pr[go];
      ii[r] = in.ph2pr[gcp];
      distm[r] = p_q / 3.f;
      one_distm[r] = 1.f - p_q;
      base[r] = real ? in.rbase[at] : 0;
      M[r] = 0.f;
      I[r] = 0.f;
      D[r] = r < vpad ? init_d : 0.f;
    }

    // the row above this lane's first row, at the previous column
    float dg_m = 0.f, dg_i = 0.f, dg_d = slot == 0 ? init_d : 0.f;
    const int steps = hl + n_t - 1;
    for (int t = 0; t < steps; ++t) {
      const int j = t - lane;
      float up_m = __shfl_up_sync(kFull, M[R - 1], 1);
      float up_i = __shfl_up_sync(kFull, I[R - 1], 1);
      float up_d = __shfl_up_sync(kFull, D[R - 1], 1);
      if (lane == 0) {
        if (st == 0) {
          up_m = 0.f;
          up_i = 0.f;
          up_d = init_d;
        } else if (j < hl) {
          up_m = buf_m[j];
          up_i = buf_i[j];
          up_d = buf_d[j];
        }
      }
      if (lane < n_t && j >= 0 && j < hl) {
        const int hb = hap[j];
        float pm = dg_m, pi = dg_i, pd = dg_d;  // diagonal: row r-1, col j-1
        float um = up_m, ui = up_i;             // up: row r-1, col j
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float om = M[r], oi = I[r], od = D[r];  // row r, col j-1
          if (r >= vpad) {
            const float prior = (base[r] & hb) ? one_distm[r] : distm[r];
            M[r] = prior * (pm * mm[r] + (pi + pd) * gapm[r]);
            I[r] = um * mi[r] + ui * ii[r];
            D[r] = om * mi[r] + od * ii[r];  // md == mi, dd == ii
          }
          pm = om;
          pi = oi;
          pd = od;
          um = M[r];
          ui = I[r];
        }
        if (lane == n_t - 1) {
          if (last_stripe) {
            sum_m += M[R - 1];
            sum_i += I[R - 1];
          } else {
            buf_m[j] = M[R - 1];
            buf_i[j] = I[R - 1];
            buf_d[j] = D[R - 1];
          }
        }
      }
      dg_m = up_m;
      dg_i = up_i;
      dg_d = up_d;
    }
    __syncwarp();
    if (last_stripe && lane == n_t - 1) out[pair] = sum_m + sum_i;
  }
}

int rows_supported(int r) {
  return r == 2 || r == 4 || r == 5 || r == 8 || r == 12 || r == 16;
}

template <int R>
cudaError_t launch(cudaStream_t stream, const Inputs& in, float* out) {
  const int64_t blocks = (in.n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)in.smem_warp * kWarpsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pairhmm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  pairhmm_kernel<R><<<(unsigned)blocks, kWarp * kWarpsPerBlock, smem,
                      stream>>>(in, out);
  return cudaGetLastError();
}

ffi::Error PairhmmIndexed(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                          ffi::Buffer<ffi::U8> gi, ffi::Buffer<ffi::U8> gc,
                          ffi::Buffer<ffi::S8> rbase,
                          ffi::Buffer<ffi::S32> rlen,
                          ffi::Buffer<ffi::S8> hcode,
                          ffi::Buffer<ffi::S32> hlen,
                          ffi::Buffer<ffi::S32> hidx,
                          ffi::Buffer<ffi::S32> ridx,
                          ffi::Buffer<ffi::F32> ph2pr,
                          ffi::Buffer<ffi::F32> m2m, int32_t rows_per_lane,
                          float init_const, ffi::ResultBuffer<ffi::F32> out) {
  const auto qd = q.dimensions();
  const auto hd = hcode.dimensions();
  if (qd.size() != 3 || qd[2] != kReadTile || hd.size() != 3 ||
      hd[2] != kHapTile)
    return ffi::Error::InvalidArgument("pairhmm: bad tile shapes");
  if (!rows_supported(rows_per_lane))
    return ffi::Error::InvalidArgument("pairhmm: unsupported rows_per_lane");
  if (ph2pr.element_count() != 128 || m2m.element_count() != 128)
    return ffi::Error::InvalidArgument("pairhmm: tables must have 128 rows");

  Inputs in;
  in.q = q.typed_data();
  in.gi = gi.typed_data();
  in.gc = gc.typed_data();
  in.rbase = rbase.typed_data();
  in.rlen = rlen.typed_data();
  in.hcode = hcode.typed_data();
  in.hlen = hlen.typed_data();
  in.hidx = hidx.typed_data();
  in.ridx = ridx.typed_data();
  in.ph2pr = ph2pr.typed_data();
  in.m2m = m2m.typed_data();
  in.init_const = init_const;
  in.n_pairs = (int64_t)hidx.element_count() * kPairsPerTile;
  in.NR = (int)qd[0];
  in.NH = (int)hd[0];
  in.Lr = (int)qd[1];
  in.Lh = (int)hd[1];
  in.hap_bytes = (in.Lh + 15) / 16 * 16;
  const bool striped = in.Lr > kWarp * rows_per_lane;
  in.smem_warp = in.hap_bytes + (striped ? 3 * in.Lh * (int)sizeof(float) : 0);
  if (in.n_pairs == 0) return ffi::Error::Success();

  float* o = out->typed_data();
  cudaError_t err;
  switch (rows_per_lane) {
    case 2: err = launch<2>(stream, in, o); break;
    case 4: err = launch<4>(stream, in, o); break;
    case 5: err = launch<5>(stream, in, o); break;
    case 8: err = launch<8>(stream, in, o); break;
    case 12: err = launch<12>(stream, in, o); break;
    default: err = launch<16>(stream, in, o); break;
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RovacaPairhmmIndexed, PairhmmIndexed,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // q
                                  .Arg<ffi::Buffer<ffi::U8>>()   // gi
                                  .Arg<ffi::Buffer<ffi::U8>>()   // gc
                                  .Arg<ffi::Buffer<ffi::S8>>()   // rbase
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rlen
                                  .Arg<ffi::Buffer<ffi::S8>>()   // hcode
                                  .Arg<ffi::Buffer<ffi::S32>>()  // hlen
                                  .Arg<ffi::Buffer<ffi::S32>>()  // hidx
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ridx
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ph2pr
                                  .Arg<ffi::Buffer<ffi::F32>>()  // m2m
                                  .Attr<int32_t>("rows_per_lane")
                                  .Attr<float>("init_const")
                                  .Ret<ffi::Buffer<ffi::F32>>());
