"""The Hopper PairHMM kernel (ops/pairhmm/cuda.py, pairhmm_cuda.cu).

CUDA has no interpret mode, so the CPU tests check what surrounds the
kernel: the scheduler's indexed launches (packing, padding slots, spans)
against per-job scoring, the wrapper's operands, and a step-by-step numpy
model of the kernel's warp schedule against the golden oracle. The kernel
itself runs in the `gpu` tests.
"""

import numpy as np
import pytest

from rovaca_tpu import constants as C
from rovaca_tpu.ops.pairhmm import compact, cuda, golden

from conftest import FakeRead, mutate

WARP = 32


def warp_schedule(q, gi, gc, rbase, hap, R):
    """numpy model of pairhmm_kernel<R> for one (read, hap) pair: lanes own
    R rows each (boundary rows padded on top), the wavefront is skewed one
    column per lane, the last row passes down by shuffle, and stripes of
    32*R rows hand over through a row buffer."""
    f32 = np.float32
    ph2pr, m2m = compact._tables()
    rl, hl = len(q), len(hap)
    init_d = f32(C.INITIAL_CONSTANT_F32) / f32(hl)
    slots = -(-rl // R)
    pad = slots * R - rl
    n_stripes = -(-slots // WARP)
    buf = np.zeros((3, hl), f32)
    sum_m = sum_i = f32(0)
    for st in range(n_stripes):
        n_t = min(WARP, slots - st * WARP)
        last = st == n_stripes - 1
        M, I, D = (np.zeros((WARP, R), f32) for _ in range(3))
        par = np.zeros((WARP, R, 6), f32)
        base = np.zeros((WARP, R), np.int32)
        vpad = np.zeros(WARP, int)
        diag = np.zeros((WARP, 3), f32)
        diag[0, 2] = init_d if st == 0 else 0
        for lane in range(WARP):
            slot = st * WARP + lane
            vpad[lane] = pad if slot == 0 else 0
            for r in range(R):
                row = slot * R + r - pad
                real = lane < n_t and row >= 0
                p_q = ph2pr[q[row] & 127 if real else 0]
                go = gi[row] & 127 if real else 0
                gcp = gc[row] & 127 if real else 0
                par[lane, r] = (m2m[go], f32(1) - ph2pr[gcp], ph2pr[go],
                                ph2pr[gcp], p_q / f32(3), f32(1) - p_q)
                base[lane, r] = rbase[row] if real else 0
                D[lane, r] = init_d if r < vpad[lane] else 0
        for t in range(hl + n_t - 1):
            up = np.empty((WARP, 3), f32)
            up[1:] = np.stack([M[:-1, R - 1], I[:-1, R - 1], D[:-1, R - 1]],
                              1)
            if st == 0:
                up[0] = (0, 0, init_d)
            elif t < hl:
                up[0] = buf[:, t]
            for lane in range(min(n_t, t + 1)):
                j = t - lane
                if j >= hl:
                    continue
                pm, pi, pd = diag[lane]
                um, ui = up[lane, 0], up[lane, 1]
                for r in range(R):
                    om, oi, od = M[lane, r], I[lane, r], D[lane, r]
                    mm, gapm, mi, ii, distm, one = par[lane, r]
                    if r >= vpad[lane]:
                        prior = one if base[lane, r] & hap[j] else distm
                        M[lane, r] = prior * (pm * mm + (pi + pd) * gapm)
                        I[lane, r] = um * mi + ui * ii
                        D[lane, r] = om * mi + od * ii
                    pm, pi, pd = om, oi, od
                    um, ui = M[lane, r], I[lane, r]
                if lane == n_t - 1:
                    if last:
                        sum_m += M[lane, R - 1]
                        sum_i += I[lane, R - 1]
                    else:
                        buf[:, j] = M[lane, R - 1], I[lane, R - 1], \
                            D[lane, R - 1]
            diag = up
    return sum_m + sum_i


@pytest.mark.parametrize("read_len,hap_len,rows", [
    (40, 60, 2),     # one stripe, boundary padding rows in lane 0
    (64, 50, 2),     # exactly 32 lanes
    (65, 50, 2),     # two stripes: the second lane-0 reads the row buffer
    (33, 45, 1),     # two stripes of one row per lane
    (7, 9, 4),       # fewer rows than lanes, short haplotype
    (150, 120, 5),   # the 150 bp read in the Lr 192 bucket
])
def test_warp_schedule_matches_golden(rng, read_len, hap_len, rows):
    hap = "".join(rng.choice(list("ACGT"), size=hap_len))
    frag = mutate((hap * 4)[5:5 + read_len], rng, n_snp=2)[:read_len]
    read = FakeRead(frag, rng.integers(10, 40, size=len(frag)), 60)
    b = compact.build_pair_batch_compact([read], [hap])
    L = len(read.bases)
    got = warp_schedule(b.q[0, :L, 0], b.gi[0, :L, 0], b.gc[0, :L, 0],
                        b.rbase[0, :L, 0].astype(np.int32),
                        b.hcode[0, :hap_len, 0].astype(np.int32), rows)
    want = golden.compute_full_prob(read.bases, read.quals, 60, hap)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def _launch_jobs(rng, shapes, read_len=(20, 90), hap_len=(40, 150)):
    """Scheduler with compact batches for jobs of (n_reads, n_haps)."""
    from rovaca_tpu.pipeline.scheduler import PairHMMScheduler
    sched = PairHMMScheduler(engine="xla")
    for k, (n_reads, n_haps) in enumerate(shapes):
        ref = "".join(rng.choice(list("ACGT"), size=int(rng.integers(
            *hap_len))))
        haps = [ref] + [mutate(ref, rng, n_snp=2, n_ins=1)
                        for _ in range(n_haps - 1)]
        reads = []
        for _ in range(n_reads):
            L = int(rng.integers(*read_len))
            s = int(rng.integers(0, max(1, len(ref) - L)))
            frag = mutate(ref[s:s + L], rng, n_snp=1)
            reads.append(FakeRead(frag, rng.integers(10, 40, size=len(frag))))
        job = sched.submit(k, reads, [h.encode() for h in haps])
        job.batch = compact.build_pair_batch_compact(job.reads, job.haps)
    return sched


def test_build_launches_ladders_and_spans(rng):
    from rovaca_tpu.pipeline.scheduler import PairHMMScheduler as S
    sched = _launch_jobs(rng, [(3, 2), (130, 9), (5, 1)])
    launches = sched.build_launches()
    pairs = 0
    for jobs, spans, args in launches:
        q, rlen, hlen, hidx, ridx = args[0], args[4], args[6], args[7], \
            args[8]
        assert q.shape[0] in S.NR_LADDER and hlen.shape[0] in S.NH_LADDER
        assert hidx.shape[0] in S.G_LADDER
        n_real = spans[-1].stop
        assert np.all(hidx[n_real:] == -1) and np.all(ridx[n_real:] == -1)
        for job, span in zip(jobs, spans):
            b = job.batch
            assert span.stop - span.start == b.gh * b.gr
            # the job's reads and haps sit in the tiles its span indexes
            r0, h0 = ridx[span.start], hidx[span.start]
            np.testing.assert_array_equal(rlen[r0:r0 + b.gr], b.rlen)
            np.testing.assert_array_equal(hlen[h0:h0 + b.gh], b.hlen)
        pairs += n_real
    assert pairs == 1 + 2 * 2 + 1


@pytest.mark.parametrize("shapes", [
    [(3, 2), (130, 9), (5, 1)],        # multi-tile job between small ones
    [(12, 3)] * 5,                      # several jobs in one launch
])
def test_indexed_launch_matches_per_job_scoring(rng, shapes):
    """The packed launch through the XLA scan (same ABI as the kernel) gives
    each job exactly what scoring it alone gives."""
    sched = _launch_jobs(rng, shapes)
    jobs = list(sched.jobs)
    n_launches = len(sched.build_launches())
    sched._collect_fn = sched._dispatch_indexed(
        compact.pairhmm_indexed_compact)
    packed = sched.collect()
    from rovaca_tpu.pipeline.scheduler import PairHMMScheduler
    for job in jobs:
        single = PairHMMScheduler(engine="xla")
        single.submit(job.key, job.reads, job.haps)
        lik, kept = single.run()[job.key]
        lik_p, kept_p = packed[job.key]
        np.testing.assert_array_equal(kept_p, kept)
        np.testing.assert_allclose(lik_p, lik, rtol=1e-6, atol=1e-9)
    assert sched.counters["pairhmm_device_launches"] == n_launches
    assert sched.counters["pairhmm_device_pairs"] == sum(
        len(j.reads) * len(j.haps) for j in jobs)


def test_kernel_operands(rng):
    sched = _launch_jobs(rng, [(4, 2)])
    (_, _, args), = sched.build_launches()
    ops = cuda.kernel_inputs(*args)
    assert [str(o.dtype) for o in ops] == [
        "uint8", "uint8", "uint8", "int8", "int32", "int8", "int32",
        "int32", "int32", "float32", "float32"]
    ph2pr, m2m = compact._tables()
    np.testing.assert_array_equal(ops[9], ph2pr)
    np.testing.assert_array_equal(ops[10], m2m)


@pytest.mark.parametrize("bucket,longest", [
    (64, 64), (128, 128), (192, 160), (256, 256), (384, 384), (512, 512)])
def test_rows_per_lane_cover_the_bucket(bucket, longest):
    """One warp pass (32 lanes x R rows) covers the bucket's typical
    reads; longer ones take a second stripe."""
    assert WARP * cuda.rows_per_lane(bucket) == longest


def _noisy_job(sched, rng, key):
    """A region of 150 bp reads, half of them noisy enough that their raw
    probabilities fall on both sides of the float32 rescue threshold."""
    import simdata
    reads, haps = simdata.pairhmm_region(rng, 96, 4, hap_len=(200, 260),
                                         noisy=0.5)
    job = sched.submit(key, reads, haps)
    job.batch = compact.build_pair_batch_compact(reads, haps)


def _check_rescue_agreement(got, want):
    """Pairs at or above MIN_ACCEPTED_F32 on either side agree to 2e-4, so
    both engines send the same pairs to the float64 rescue unless a pair
    sits within that tolerance of the threshold. Returns the number of
    pairs below the threshold on both sides."""
    lo = np.float32(C.MIN_ACCEPTED_F32)
    scored = np.maximum(got, want) >= lo
    np.testing.assert_allclose(got[scored], want[scored], rtol=2e-4)
    return int((~scored).sum())


def test_noisy_reads_straddle_the_rescue_threshold(rng):
    """The XLA launch (the kernel's reference on the card) and the native
    float32 engine agree on which noisy-read pairs go to the rescue."""
    from rovaca_tpu.native import pairhmm_native
    from rovaca_tpu.ops.pairhmm import prep
    from rovaca_tpu.pipeline.scheduler import PairHMMScheduler
    sched = PairHMMScheduler(engine="xla")
    _noisy_job(sched, rng, 0)
    (job,), (span,), args = sched.build_launches()[0]
    raw = np.asarray(compact.pairhmm_indexed_compact(*args))
    b = job.batch
    got = b.result_matrix(raw[span].reshape(b.gh, b.gr, 8, 128))
    dense = prep.build_pair_batch(job.reads, job.haps)
    want = dense.result_matrix(pairhmm_native.pairhmm_dense(
        dense.trans, dense.rbase, dense.rlen, dense.hbase, dense.hlen))
    below = _check_rescue_agreement(got, want)
    assert 0 < below < got.size


@pytest.mark.gpu
def test_kernel_matches_xla_on_card(gpu, rng):
    """Varied read lengths (one and two stripes, empty lanes), unused pair
    slots and pairs on both sides of the rescue threshold, against the XLA
    scan of the same launch."""
    import jax
    sched = _launch_jobs(rng, [(3, 2), (130, 9), (40, 5), (7, 1)],
                         read_len=(20, 190), hap_len=(100, 380))
    _noisy_job(sched, rng, 4)
    below = 0
    for jobs, spans, args in sched.build_launches():
        dargs = [jax.device_put(a) for a in args]
        got = np.asarray(cuda.pairhmm_cuda_indexed(*dargs))
        want = np.asarray(compact.pairhmm_indexed_compact(*dargs))
        real = slice(0, spans[-1].stop)
        below += _check_rescue_agreement(got[real], want[real])
        assert np.all(got[spans[-1].stop:] == 0)
    assert below > 0
