"""End-to-end PairHMM scoring: dispatch, rescue, normalization, filtering.

Mirrors the behavior of the reference's call_pairhmm pipeline
(reference: src/haplotypecaller/pairhmm/pairhmm_internal.cpp:596-753):
float kernel first, double-precision host rescue for underflows
(< 1e-28), per-read cap at best-4.5, poorly-modelled-read removal, and a
[hap][read] result matrix.
"""

import numpy as np

from ... import constants as C
from ...utils.platform import pinned_to_cpu
from . import golden, prep

ENGINES = ("auto", "cuda", "xla", "native")


class NoDeviceError(RuntimeError):
    """`auto` found no GPU and the process is not pinned to the CPU."""


def choose_engine(requested="auto"):
    """Resolve a PairHMM engine name; the one place "auto" is decided.

    - cuda: the Hopper kernel (cuda.py) on JAX's GPU backend;
    - native: the host C++ engine, only when the process is pinned to the
      CPU (JAX_PLATFORMS=cpu, as tests and CPU-only users run);
    - xla: the XLA scan on JAX's default device, by request only.

    "auto" with neither a GPU nor the CPU pin is an error: scoring never
    drops to the host unasked."""
    if requested not in ENGINES:
        raise ValueError(f"unknown pairhmm engine: {requested!r}")
    if requested != "auto":
        return requested
    if pinned_to_cpu():
        return "native"
    import jax
    backend = jax.default_backend()
    if backend == "gpu":
        return "cuda"
    raise NoDeviceError(
        f"no GPU found for PairHMM scoring (JAX backend: {backend!r}); "
        "set JAX_PLATFORMS=cpu to score on the host")


def engine_device(engine):
    """What an engine runs on, for the start-of-run log line."""
    if engine == "native":
        return "host CPU"
    import jax
    devices = jax.local_devices()
    return (f"{len(devices)} x {devices[0].device_kind} "
            f"({devices[0].platform})")


def indexed_launch(engine):
    """The compact indexed launch (scheduler ABI) of a device engine: the
    Hopper kernel for cuda, the XLA scan for xla."""
    if engine == "cuda":
        from .cuda import pairhmm_cuda_indexed
        return pairhmm_cuda_indexed
    if engine == "xla":
        from .compact import pairhmm_indexed_compact
        return pairhmm_indexed_compact
    raise ValueError(f"pairhmm engine {engine!r} has no device launch")


def log10_with_rescue(raw_matrix, reads, haps, pcr_model="CONSERVATIVE",
                      min_quality_threshold=C.MIN_QUALITY_THRESHOLD):
    """float32 log10 with double rescue (pairhmm_internal.cpp:674-689).

    raw_matrix: (n_haps, n_reads) f32 raw forward probabilities.
    Returns (n_haps, n_reads) float64 log10 likelihoods.
    """
    raw = np.asarray(raw_matrix, dtype=np.float32)
    out = np.empty(raw.shape, dtype=np.float64)
    ok = raw >= np.float32(C.MIN_ACCEPTED_F32)
    logf = np.full(raw.shape, np.nan, dtype=np.float32)
    np.log10(raw, out=logf, where=ok)
    out[ok] = (logf[ok] - np.float32(C.LOG10_INITIAL_CONSTANT_F32)).astype(np.float64)

    hap_bytes = [h.encode() if isinstance(h, str) else bytes(h) for h in haps]
    rescued = list(zip(*np.nonzero(~ok)))
    if rescued:
        from ...native import pairhmm_native
        if pairhmm_native.rescue_available():
            ch_cache, hap_cache = {}, {}
            for h_idx, r_idx in rescued:
                if r_idx not in ch_cache:
                    read = reads[r_idx]
                    ch_cache[r_idx] = prep.prepare_read_channels(
                        read.bases, read.quals, read.mapping_quality,
                        ins_gops=getattr(read, "ins_quals", None),
                        gcp=getattr(read, "gcp", None),
                        pcr_model=pcr_model,
                        min_quality_threshold=min_quality_threshold,
                        dtype=np.float64)
                if h_idx not in hap_cache:
                    hap_cache[h_idx] = prep.BASE_CODE[
                        np.frombuffer(hap_bytes[h_idx], dtype=np.uint8)]
                codes, ch = ch_cache[r_idx]
                rd = pairhmm_native.forward_f64(ch, codes, hap_cache[h_idx])
                out[h_idx, r_idx] = (np.log10(rd)
                                     - C.LOG10_INITIAL_CONSTANT_F64)
            return out
    if len(rescued) >= 8:
        try:
            raws = _rescue_batch_f64(rescued, reads, hap_bytes, pcr_model,
                                     min_quality_threshold)
        except RuntimeError:
            # no CPU backend registered (JAX_PLATFORMS names none): fall
            # through to the numpy golden forward
            raws = None
    else:
        raws = None
    for k, (h_idx, r_idx) in enumerate(rescued):
        if raws is not None:
            rd = raws[k]
        else:
            read = reads[r_idx]
            rd = golden.compute_full_prob(
                read.bases, read.quals, read.mapping_quality,
                hap_bytes[h_idx],
                ins_gops=getattr(read, "ins_quals", None),
                gcp=getattr(read, "gcp", None),
                dtype=np.float64, pcr_model=pcr_model,
                min_quality_threshold=min_quality_threshold)
        out[h_idx, r_idx] = np.log10(rd) - C.LOG10_INITIAL_CONSTANT_F64
    return out


def _rescue_batch_f64(rescued, reads, hap_bytes, pcr_model,
                      min_quality_threshold):
    """Vectorized float64 rescue on the CPU backend: score each rescued
    (read, hap) pair via the XLA scan path under enable_x64. Returns raw
    probabilities aligned with `rescued`."""
    import jax

    from .xla import pairhmm_xla

    pair_reads = [reads[r] for _, r in rescued]
    pair_haps = [hap_bytes[h] for h, _ in rescued]
    batch = prep.build_pair_batch(pair_reads, pair_haps,
                                  pcr_model=pcr_model,
                                  min_quality_threshold=min_quality_threshold,
                                  dtype=np.float64)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        raw = np.asarray(pairhmm_xla(
            batch.trans, batch.rbase, batch.rlen, batch.hbase, batch.hlen))
    full = batch.result_matrix(raw)      # (n_pairs_hap, n_pairs_read)
    return np.array([full[k, k] for k in range(len(rescued))],
                    dtype=np.float64)


def normalize_likelihoods(lik_by_read):
    """Cap each read's likelihoods at best - 4.5 in place
    (pairhmm_internal.cpp:53-63)."""
    best = np.max(lik_by_read, axis=1, keepdims=True)
    cap = best + C.MAXIMUM_BEST_ALT_LIKELIHOOD_DIFFERENCE
    return np.maximum(lik_by_read, cap)


def poorly_modelled_mask(read_lengths, lik_by_read):
    """True where a read is poorly modelled and must be dropped
    (pairhmm_internal.cpp:161-182)."""
    best = np.max(lik_by_read, axis=1)
    thresh = np.minimum(
        C.MAXIMUM_EXPECTED_ERROR_PER_READ,
        np.ceil(np.asarray(read_lengths) * C.EXPECTED_ERROR_RATE_PER_BASE),
    ) * C.LOG10_QUALITY_PER_BASE
    return best < thresh


def compute_likelihoods(reads, haps, pcr_model="CONSERVATIVE",
                        min_quality_threshold=C.MIN_QUALITY_THRESHOLD,
                        engine="auto"):
    """Score all (read, hap) pairs of one region.

    Returns (likelihoods, kept_indices): likelihoods is an
    (n_haps, n_kept_reads) float64 log10 matrix; kept_indices maps its read
    columns back into `reads` after poorly-modelled-read removal. Runs as a
    one-job PairHMMScheduler batch, so every engine goes through the same
    dispatch as the pipeline.
    """
    from ...pipeline.scheduler import PairHMMScheduler
    sched = PairHMMScheduler(engine=engine,
                             min_quality_threshold=min_quality_threshold)
    sched.submit(0, reads, haps, pcr_model=pcr_model)
    return sched.run()[0]
