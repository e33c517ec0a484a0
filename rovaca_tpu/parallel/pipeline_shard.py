"""Full-pipeline data parallelism over a device mesh.

This is the device-level half of the scale-out story (the process-level
half is parallel/distributed.py): genomic interval shards map onto mesh
devices; every device scores its own shard's PairHMM batches inside ONE
jitted `shard_map` step; results all_gather in shard (== genome) order; the
host genotypes per shard and merges records coordinate-ordered — the
reference's source_id-ordered writer merge (reference:
src/haplotypecaller/writer/writer.cpp:147-196) expressed as a collective.

The device step consumes the production wire format: the compact integer
launch layout built by ops/pairhmm/compact.py (per-base quals/gap
phreds/base codes + an indexed (hap-tile, read-tile) pair list). Regions
may span multiple read/hap tiles. The scorer is the launch of the engine
api.choose_engine picks: the CUDA kernel on GPU meshes, the identical-ABI
XLA scan elsewhere (the virtual CPU-device dryrun).

`pipeline_dryrun(n_devices)` drives regions → assembly → sharded PairHMM →
genotyping → ordered merge end-to-end on an n-device mesh and asserts the
merged records equal an unsharded run; on N virtual CPU devices it
validates the multi-device path without N cards.
"""

import numpy as np

from .. import constants as C
from .sharding import make_data_mesh, shard_intervals

_DRY_LR = 64     # fixed read-length bucket for the dryrun step
_DRY_LH = 512    # fixed hap-length bucket (indel regions re-pad haps)
_DRY_NR = 32     # read tiles per shard launch
_DRY_NH = 16     # hap tiles per shard launch
_DRY_G = 96      # (hap-tile, read-tile) pairs per shard launch


# --------------------------------------------------------------------------
# device step
# --------------------------------------------------------------------------

def sharded_pipeline_step(mesh, q, gi, gc, rbase, rlen, hcode, hlen,
                          hidx, ridx, axis_name="data"):
    """One jitted multi-device step over per-shard compact indexed launches.

    Inputs carry an [S, ...] leading dim (S = mesh size): per shard, the
    compact launch arrays exactly as the production scheduler ships them
    (scheduler._dispatch_indexed). Returns raw scores [S, G, 8, 128]
    gathered on every device in shard order.
    """
    import jax
    from jax.sharding import PartitionSpec as P

    from ..ops.pairhmm.api import choose_engine, indexed_launch
    from ..utils.platform import pinned_to_cpu
    launch = indexed_launch("xla" if pinned_to_cpu() else choose_engine())

    def step(q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx):
        raw = launch(q[0], gi[0], gc[0], rbase[0], rlen[0], hcode[0],
                     hlen[0], hidx[0], ridx[0])
        return jax.lax.all_gather(raw, axis_name)

    spec = P(axis_name)
    fn = jax.shard_map(step, mesh=mesh,
                       in_specs=(spec,) * 9, out_specs=P(),
                       check_vma=False)
    return jax.jit(fn)(q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx)


def _postprocess(batch, raw, reads, haps, pcr_model, mqt):
    """scheduler._postprocess equivalent for one region (multi-tile)."""
    from ..ops.pairhmm.api import (log10_with_rescue, normalize_likelihoods,
                                   poorly_modelled_mask)
    lik_hr = log10_with_rescue(batch.result_matrix(raw), reads, haps,
                               pcr_model=pcr_model,
                               min_quality_threshold=mqt)
    lik_rh = normalize_likelihoods(lik_hr.T)
    drop = poorly_modelled_mask([len(r.bases) for r in reads], lik_rh)
    kept = np.nonzero(~drop)[0]
    return lik_rh[kept].T.copy(), kept


# --------------------------------------------------------------------------
# dryrun: simulate -> regions -> sharded step -> genotype -> merge
# --------------------------------------------------------------------------

def _simulate(genome_len=16000, coverage=24, read_len=50, seed=20260819):
    """Tiny in-memory diploid case with SNPs AND indels; reads sampled
    from the alt haplotype get real cigars by SW alignment to the
    reference (the same GATK-exact SW the production pipeline uses)."""
    from ..assembly.sw import (READ_TO_HAPLOTYPE_PARAMS, OverhangStrategy,
                               sw_align)
    from ..reads.record import ReadRecord

    rng = np.random.default_rng(seed)
    contig = "chr20"
    ref = "".join(rng.choice(list("ACGT"), size=genome_len))
    # het SNP / insertion / deletion alternating every ~1500bp
    truth = []
    kinds = ["snp", "snp", "ins", "snp", "del"]
    for n, pos in enumerate(range(700, genome_len - 700, 1500)):
        kind = kinds[n % len(kinds)]
        if kind == "snp":
            alt = "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]
            truth.append((pos, ref[pos], alt))
        elif kind == "ins":
            truth.append((pos, ref[pos], ref[pos] + "ACT"))
        else:
            truth.append((pos, ref[pos:pos + 4], ref[pos]))
    alt_ref = []
    prev = 0
    for pos, r, a in truth:
        alt_ref.append(ref[prev:pos])
        alt_ref.append(a)
        prev = pos + len(r)
    alt_ref.append(ref[prev:])
    alt_ref = "".join(alt_ref)

    # projection of alt-hap coordinates to reference coordinates
    shifts = []   # (alt_pos_after, ref_delta)
    delta = 0
    for pos, r, a in truth:
        delta += len(a) - len(r)
        shifts.append((pos + delta, len(a) - len(r)))

    def ref_pos_of(alt_pos):
        d = 0
        for ap, dd in shifts:
            if alt_pos >= ap:
                d += dd
        return alt_pos - d

    reads = []
    for hap_i, hap in enumerate((ref, alt_ref)):
        n_reads = coverage * len(hap) // read_len // 2
        for i in range(n_reads):
            s = int(rng.integers(0, len(hap) - read_len))
            bases = hap[s:s + read_len]
            if hap_i == 0:
                pos, cigar = s, f"{read_len}M"
            else:
                # align read to the reference around its projected start
                rp = ref_pos_of(s)
                lo = max(0, rp - 12)
                seg = ref[lo:rp + read_len + 12]
                res = sw_align(seg, bases, READ_TO_HAPLOTYPE_PARAMS,
                               OverhangStrategy.SOFTCLIP)
                pos = lo + res.alignment_offset
                cigar = str(res.cigar)
            reads.append(ReadRecord(
                name=f"h{hap_i}_{i}", flag=0, ref_id=0, pos=pos,
                mapping_quality=60, cigar=cigar, bases=bases,
                quals=rng.integers(30, 40, size=read_len),
                contig=contig))
    reads.sort(key=lambda r: r.pos)
    from ..utils.refwindow import RefWindow
    return contig, RefWindow(ref.encode(), 0), reads, truth


def _regions_for_span(reads, ref, contig, lo, hi):
    from ..pipeline import activity
    sel = [r for r in reads if r.pos < hi and r.end > lo]
    if not sel:
        return [], sel
    regions = activity.find_active_regions(sel, ref, contig, lo, hi)
    return [rg for rg in regions if rg.is_active], sel


def _record_key(v):
    """FIELD-LEVEL record identity: site + alleles + GT + QUAL + INFO
    annotations + FORMAT (AD/DP/GQ/PL). A sharding bug that perturbed
    annotations or likelihoods without flipping the genotype must fail
    the dryrun equality, same bar as the golden e2e diff."""
    def _num(x):
        return round(float(x), 4) if isinstance(x, float) else x

    g = v.genotypes[0] if v.genotypes else None
    gt = tuple(sorted(a.bases for a in g.alleles)) if g else ()
    fmt = (tuple(g.ad or ()), g.dp, g.gq, tuple(g.pl or ())) if g else ()
    info = tuple(sorted((k, _num(val))
                        for k, val in (v.attributes or {}).items()))
    return (v.contig, v.start, bytes(v.ref.bases),
            tuple(bytes(a.bases) for a in v.alts), gt,
            round(v.qual, 2), info, fmt)


def _pack_shard_launch(entries, pcr_model):
    """Pack a shard's region batches into ONE compact indexed launch with
    the production layout (mirrors scheduler._dispatch_indexed packing)."""
    from ..ops.pairhmm.compact import build_pair_batch_compact

    q = np.zeros((_DRY_NR, _DRY_LR, 128), np.uint8)
    gi = np.zeros((_DRY_NR, _DRY_LR, 128), np.uint8)
    gc = np.zeros((_DRY_NR, _DRY_LR, 128), np.uint8)
    rbase = np.zeros((_DRY_NR, _DRY_LR, 128), np.int8)
    # padding slots get 1-base lengths so the kernel stays well-defined
    rlen = np.ones((_DRY_NR, 1, 128), np.int32)
    hcode = np.zeros((_DRY_NH, _DRY_LH, 8), np.int8)
    hlen = np.ones((_DRY_NH, 8, 1), np.int32)
    hidx = np.zeros(_DRY_G, np.int32)
    ridx = np.zeros(_DRY_G, np.int32)

    r_off = h_off = g_off = 0
    packed = []   # (prepared, batch, reads, haps, pair_slice, gh, gr)
    for prepared, rg_reads, haps in entries:
        batch = build_pair_batch_compact(
            rg_reads, haps, pcr_model=pcr_model,
            len_buckets=(_DRY_LR,), hap_len_buckets=(_DRY_LH,))
        npairs = batch.gh * batch.gr
        assert (r_off + batch.gr <= _DRY_NR and h_off + batch.gh <= _DRY_NH
                and g_off + npairs <= _DRY_G), \
            "dryrun shard launch capacity exceeded"
        q[r_off:r_off + batch.gr] = batch.q
        gi[r_off:r_off + batch.gr] = batch.gi
        gc[r_off:r_off + batch.gr] = batch.gc
        rbase[r_off:r_off + batch.gr] = batch.rbase
        rlen[r_off:r_off + batch.gr] = batch.rlen
        hcode[h_off:h_off + batch.gh] = batch.hcode
        hlen[h_off:h_off + batch.gh] = batch.hlen
        k = g_off
        for hh in range(batch.gh):
            for rr in range(batch.gr):
                hidx[k] = h_off + hh
                ridx[k] = r_off + rr
                k += 1
        packed.append((prepared, batch, rg_reads, haps,
                       (g_off, k)))
        r_off += batch.gr
        h_off += batch.gh
        g_off = k
    return (q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx), packed


def pipeline_dryrun(n_devices, pcr_model="CONSERVATIVE",
                    genome_len=16000):
    """regions -> sharded PairHMM -> genotyping -> ordered merge over an
    n-device mesh; asserts equality with the unsharded pipeline."""
    import jax

    from ..pipeline.hc_engine import CallerConfig, RegionCaller

    contig, ref, reads, truth = _simulate(genome_len=genome_len)
    genome_len = len(ref)
    config = CallerConfig(pairhmm_engine="xla", pcr_indel_model=pcr_model)
    contig_dict = {contig: genome_len}

    # ---- unsharded baseline --------------------------------------------
    caller = RegionCaller(config, contig_dict)
    base_records = []
    regions, sel = _regions_for_span(reads, ref, contig, 0, genome_len)
    for rg in regions:
        rg_reads = [r for r in sel
                    if r.pos < rg.end + 1 + C.REGION_PADDING
                    and r.end > rg.start - C.REGION_PADDING]
        base_records.extend(caller.call_region(rg, rg_reads, ref, contig))
    base_keys = [_record_key(v) for v in base_records]

    # ---- sharded run ----------------------------------------------------
    devices = jax.devices()[:n_devices]
    mesh = make_data_mesh(devices)
    shards = shard_intervals([(contig, 0, genome_len)], n_devices)

    mqt = C.MIN_QUALITY_THRESHOLD
    per_shard = []   # (shard_caller, ready_records, packed)
    launches = []
    for shard in shards:
        shard_caller = RegionCaller(config, contig_dict)
        entries, ready = [], []
        for (ctg, pad_s, pad_e, core_s, core_e) in shard:
            regions, sel = _regions_for_span(reads, ref, ctg, pad_s, pad_e)
            for rg in regions:
                # ownership: the shard whose core span holds the region
                # midpoint calls it (regions never straddle shards)
                mid = (rg.start + rg.end + 1) // 2
                if not (core_s <= mid < core_e):
                    continue
                rg_reads = [r for r in sel
                            if r.pos < rg.end + 1 + C.REGION_PADDING
                            and r.end > rg.start - C.REGION_PADDING]
                prepared = shard_caller.prepare_region(rg, rg_reads, ref,
                                                       ctg)
                if isinstance(prepared, list):
                    ready.extend(prepared)
                    continue
                entries.append((prepared, prepared.call_reads,
                                [h.bases for h in prepared.haps]))
        launch, packed = _pack_shard_launch(entries, pcr_model)
        launches.append(launch)
        per_shard.append((shard_caller, ready, packed))

    stacked = tuple(np.stack([ln[i] for ln in launches])
                    for i in range(9))
    gathered = np.asarray(sharded_pipeline_step(mesh, *stacked))
    assert gathered.shape[:2] == (n_devices, _DRY_G), gathered.shape

    sharded_records = []
    for si, (shard_caller, ready, packed) in enumerate(per_shard):
        sharded_records.extend(ready)
        for prepared, batch, rg_reads, haps, (g0, g1) in packed:
            # reassemble this region's (gh, gr) tile block from the
            # launch's flat pair rows (packing is job-contiguous)
            raw = gathered[si, g0:g1].reshape(batch.gh, batch.gr, 8, 128)
            lik, kept = _postprocess(batch, raw, rg_reads, haps,
                                     pcr_model, mqt)
            sharded_records.extend(
                shard_caller.finish_region(prepared, lik, kept))
    sharded_records.sort(key=lambda v: (v.contig, v.start))
    sharded_keys = [_record_key(v) for v in sharded_records]

    if sharded_keys != base_keys:
        only_b = set(base_keys) - set(sharded_keys)
        only_s = set(sharded_keys) - set(base_keys)
        raise AssertionError(
            f"sharded != unsharded: base-only={sorted(only_b)[:5]} "
            f"sharded-only={sorted(only_s)[:5]}")
    if len(base_keys) < len(truth) // 2:
        raise AssertionError(
            f"dryrun called too few variants: {len(base_keys)} records "
            f"for {len(truth)} truth variants")
    return len(base_keys)
