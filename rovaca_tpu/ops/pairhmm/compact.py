"""Compact PairHMM batches: integers over the wire, channels on device.

The dense layout ships 8 float32 transition/emission channels per read base
(36B/base) and lane-broadcast int32 haplotype codes (512B/hap-base). All of
it is a pure function of small integers, so this path ships just the
integers — per-base quals, gap-open, gap-continuation (uint8, after host-side
MQ capping and the native PCR/STR caps) and 4-bit base codes — and
materializes channels on device from (128,) probability tables: ~10x fewer
host->device bytes for reads, ~500x for haplotypes. The reference has no
analogous stage (in-process SIMD reads its own memory; reference:
src/haplotypecaller/pairhmm/pairhmm_internal.cpp:413-483 does the table
lookups on the CPU inline).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ... import constants as C
from .. import gatk_math
from . import prep
from .xla import pairhmm_xla_indexed


@functools.lru_cache(maxsize=None)
def _tables():
    ph2pr = np.asarray(gatk_math.ph2pr_table(np.float32))
    m2m = np.asarray(gatk_math.match_to_match_table(np.float32))
    m2m_diag = m2m[np.arange(128), np.arange(128)]  # ins gop == del gop
    return ph2pr, m2m_diag


def materialize_channels(q, gi, gc):
    """(..., Lr, 128) uint8 quals/gap-open/gap-cont -> (..., Lr, 8, 128) f32
    channels in prep.py order [mm, gapm, mi, ii, md, dd, distm, one_distm]."""
    ph2pr_np, m2m_np = _tables()
    ph2pr = jnp.asarray(ph2pr_np)
    m2m = jnp.asarray(m2m_np)
    qi = q.astype(jnp.int32)
    gii = gi.astype(jnp.int32)
    gci = gc.astype(jnp.int32)
    p_gi = jnp.take(ph2pr, gii, axis=0)
    p_gc = jnp.take(ph2pr, gci, axis=0)
    p_q = jnp.take(ph2pr, qi, axis=0)
    one = jnp.float32(1.0)
    ch = jnp.stack([
        jnp.take(m2m, gii, axis=0),     # mm
        one - p_gc,                     # gapm
        p_gi,                           # mi
        p_gc,                           # ii
        p_gi,                           # md (del gop aliases ins gop)
        p_gc,                           # dd
        p_q / jnp.float32(3.0),         # distm
        one - p_q,                      # one_distm
    ], axis=-2)
    return ch


def broadcast_haps(hcode):
    """(..., Lh, 8) int8 hap codes -> (..., Lh, 8, 128) int32 lane-bcast."""
    return jnp.broadcast_to(hcode.astype(jnp.int32)[..., None],
                            hcode.shape + (128,))


@jax.jit
def pairhmm_indexed_compact(q, gi, gc, rbase8, rlen, hcode8, hlen,
                            hidx, ridx):
    """The compact indexed launch in XLA: channels and lane-broadcast hap
    tiles materialize on device, then the scan path scores the G tile
    pairs. Same ABI and output as cuda.pairhmm_cuda_indexed."""
    trans = materialize_channels(q, gi, gc)
    return pairhmm_xla_indexed(trans, rbase8.astype(jnp.int32), rlen,
                               broadcast_haps(hcode8), hlen, hidx, ridx)


@dataclasses.dataclass
class CompactPairBatch:
    """Integer-typed, tiled PairHMM inputs (device materializes channels).

    Shapes: q/gi/gc: (GR, Lr, 128) u8; rbase: (GR, Lr, 128) i8;
    rlen: (GR, 1, 128) i32; hcode: (GH, Lh, 8) i8; hlen: (GH, 8, 1) i32.
    """
    q: np.ndarray
    gi: np.ndarray
    gc: np.ndarray
    rbase: np.ndarray
    rlen: np.ndarray
    hcode: np.ndarray
    hlen: np.ndarray
    n_reads: int
    n_haps: int

    @property
    def gr(self):
        return self.q.shape[0]

    @property
    def gh(self):
        return self.hcode.shape[0]

    @property
    def max_read_len(self):
        return self.q.shape[1]

    @property
    def max_hap_len(self):
        return self.hcode.shape[1]

    def result_matrix(self, raw):
        """(GH, GR, 8, 128) kernel output -> (n_haps, n_reads) float32."""
        raw = np.asarray(raw)
        gh, gr = raw.shape[0], raw.shape[1]
        full = raw.transpose(0, 2, 1, 3).reshape(gh * prep.HAP_TILE,
                                                 gr * prep.READ_TILE)
        return full[: self.n_haps, : self.n_reads]


def build_pair_batch_compact(reads, haps, pcr_model="CONSERVATIVE",
                             min_quality_threshold=C.MIN_QUALITY_THRESHOLD,
                             len_buckets=(64, 128, 192, 256, 384, 512),
                             hap_len_buckets=(128, 256, 384, 512, 768, 1024)):
    """Compact analogue of prep.build_pair_batch (same semantics/buckets)."""
    n_reads = len(reads)
    n_haps = len(haps)
    hap_bytes = [h.encode() if isinstance(h, str) else bytes(h) for h in haps]

    max_rl = max(len(r.bases) for r in reads)
    max_hl = max(len(h) for h in hap_bytes)
    Lr = next((b for b in len_buckets if b >= max_rl),
              prep._round_up(max_rl, 128))
    Lh = next((b for b in hap_len_buckets if b >= max_hl),
              prep._round_up(max_hl, 128))
    GR = prep._round_up(n_reads, prep.READ_TILE) // prep.READ_TILE
    GH = prep._round_up(n_haps, prep.HAP_TILE) // prep.HAP_TILE

    q_a = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.uint8)
    gi_a = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.uint8)
    gc_a = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.uint8)
    rbase = np.zeros((GR, Lr, prep.READ_TILE), dtype=np.int8)
    rlen = np.zeros((GR, 1, prep.READ_TILE), dtype=np.int32)
    hcode = np.zeros((GH, Lh, prep.HAP_TILE), dtype=np.int8)
    hlen = np.zeros((GH, prep.HAP_TILE, 1), dtype=np.int32)

    base_bytes = [r.bases.encode() if isinstance(r.bases, str)
                  else bytes(r.bases) for r in reads]
    gap_list = []
    for r, bb in zip(reads, base_bytes):
        ig = getattr(r, "ins_quals", None)
        if ig is None:
            ig = np.full(len(bb), C.DEFAULT_GAP_OPEN_PHRED, dtype=np.uint8)
        else:
            ig = np.asarray(ig, dtype=np.uint8).copy()
        gap_list.append(ig)
    prep.apply_pcr_error_model_batch(base_bytes, gap_list, pcr_model)

    for idx, read in enumerate(reads):
        g, lane = divmod(idx, prep.READ_TILE)
        bb = base_bytes[idx]
        L = len(bb)
        q = prep.modify_read_quals(read.quals, read.mapping_quality,
                                   min_quality_threshold)
        gcp = getattr(read, "gcp", None)
        if gcp is None:
            gcp = np.full(L, C.GAP_CONTINUATION_PHRED, dtype=np.uint8)
        q_a[g, :L, lane] = q & 127
        gi_a[g, :L, lane] = gap_list[idx] & 127
        gc_a[g, :L, lane] = np.asarray(gcp, dtype=np.uint8) & 127
        rbase[g, :L, lane] = prep.BASE_CODE[
            np.frombuffer(bb, dtype=np.uint8)]
        rlen[g, 0, lane] = L

    for idx, h in enumerate(hap_bytes):
        g, sub = divmod(idx, prep.HAP_TILE)
        hcode[g, : len(h), sub] = prep.BASE_CODE[
            np.frombuffer(h, dtype=np.uint8)]
        hlen[g, sub, 0] = len(h)

    return CompactPairBatch(q=q_a, gi=gi_a, gc=gc_a, rbase=rbase, rlen=rlen,
                            hcode=hcode, hlen=hlen,
                            n_reads=n_reads, n_haps=n_haps)
