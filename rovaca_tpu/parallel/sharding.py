"""Interval-sharded data parallelism over a device mesh.

The reference's entire parallelism story is single-node pipelined data
parallelism over genomic coordinates (reference: src/haplotypecaller/
ActiveRegion/ActiveMainThread.cpp:9-56, haplotypecaller.cpp:45-181). Here
(BASELINE.json north star):

- the FASTA dict is replicated per host; genomic intervals are sharded
  data-parallel across the mesh with boundary padding so active regions never
  span a shard cut;
- each shard runs the full pipeline on its intervals, with PairHMM batches on
  its cards;
- per-shard VCF record streams merge in coordinate order (shard order ==
  genome order), mirroring the reference's source_id-ordered writer merge
  (reference: src/haplotypecaller/writer/writer.cpp:147-196) across devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..ops.pairhmm.xla import pairhmm_xla


def make_data_mesh(devices=None, axis_name="data"):
    """A 1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_intervals(intervals, n_shards,
                    boundary_pad=C.REGION_MAX_SIZE + C.REGION_PADDING):
    """Split (contig, start, end) intervals into n_shards contiguous shards.

    Splits are balanced by total base count. Each shard keeps `boundary_pad`
    extra context on cut edges (reads near a cut are processed by the shard
    that owns the region midpoint, so regions never straddle shards — the
    sharded analogue of the reference's per-chromosome sequential semantics).

    Returns a list of n_shards lists of (contig, start, end, core_start,
    core_end) where [core_start, core_end) is the half-open ownership span.
    """
    total = sum(e - s for _, s, e in intervals)
    per_shard = max(1, -(-total // n_shards))
    shards = [[] for _ in range(n_shards)]
    shard_idx, filled = 0, 0
    for contig, start, end in intervals:
        pos = start
        while pos < end:
            take = min(end - pos, per_shard - filled)
            core_s, core_e = pos, pos + take
            pad_s = max(start, core_s - boundary_pad)
            pad_e = min(end, core_e + boundary_pad)
            shards[min(shard_idx, n_shards - 1)].append(
                (contig, pad_s, pad_e, core_s, core_e))
            pos += take
            filled += take
            if filled >= per_shard and shard_idx < n_shards - 1:
                shard_idx += 1
                filled = 0
    return shards


def sharded_pairhmm_step(mesh, trans, rbase, rlen, hbase, hlen,
                         axis_name="data"):
    """One data-parallel PairHMM scoring step over the mesh.

    Inputs carry a leading shard dim equal to the mesh size:
      trans (S, GR, Lr, 8, 128), rbase (S, GR, Lr, 128), rlen (S, GR, 1, 128),
      hbase (S, GH, Lh, 8, 128), hlen (S, GH, 8, 1).
    Returns (gathered raw results (S, GH, GR, 8, 128) on every device in
    shard/coordinate order, global best-likelihood stat) — the gather is the
    collectives-backed ordered merge of per-shard results.
    """
    def step(trans, rbase, rlen, hbase, hlen):
        raw = pairhmm_xla(trans[0], rbase[0], rlen[0], hbase[0], hlen[0])
        # global scalar statistic exercises a cross-shard reduction
        local_best = jnp.max(raw)
        global_best = jax.lax.pmax(local_best, axis_name)
        # ordered merge: gather shard results along the shard axis (shard
        # order == genomic coordinate order by construction)
        gathered = jax.lax.all_gather(raw, axis_name)
        return gathered, global_best

    spec = P(axis_name)
    shard_mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(shard_mapped)(trans, rbase, rlen, hbase, hlen)


def ordered_merge(per_shard_records):
    """Host-side coordinate-ordered merge of per-shard record lists.

    Each element is a list of records already sorted within its shard; shards
    are genome-ordered, so the merge is concatenation with cross-boundary
    dedup by ownership span (records outside a shard's core span are dropped
    by the producer, so plain concatenation is exact)."""
    out = []
    for records in per_shard_records:
        out.extend(records)
    return out


@functools.lru_cache(maxsize=None)
def local_device_count():
    return jax.local_device_count()
