"""Multi-host execution via the JAX distributed runtime.

The reference is strictly single-node (SURVEY §2.14); its parallelism
contract — data parallelism over genomic coordinates with an ordered writer
merge (reference: src/haplotypecaller/haplotypecaller.cpp:45-181,
writer/writer.cpp:147-196) — is lifted here to host rank: every process owns
a contiguous interval shard (FASTA replicated, BAM read via indexed fetch of
its shard only), runs the full pipeline on its local chips, writes
`<out>.rankNNNN`, and rank 0 concatenates the genome-ordered shard outputs
after a cross-process barrier.

Wire-up:
  - `maybe_init_distributed()` initialises `jax.distributed` from standard
    env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), or
    lets jax auto-detect the cluster (ROVACA_AUTO_DISTRIBUTED, e.g. under
    SLURM or Open MPI on GPU clusters).
  - `run_distributed(args)` is the per-process driver the CLI calls when
    `jax.process_count() > 1`.
"""

import os


def maybe_init_distributed():
    """Initialise the JAX distributed runtime when env describes a multi-
    process run; harmless no-op otherwise. Returns (process_index,
    process_count)."""
    import jax
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    try:
        if coord and nproc:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(nproc),
                process_id=int(pid) if pid is not None else None)
        elif os.environ.get("ROVACA_AUTO_DISTRIBUTED"):
            # cluster environments jax detects on its own
            jax.distributed.initialize()
    except (RuntimeError, ValueError):
        pass  # already initialised (or single-process)
    return jax.process_index(), jax.process_count()


def process_shard_span(reference_path, process_index, process_count,
                       contig=None, start=None, end=None):
    """This process's contiguous (contig, core_start, core_end) spans."""
    from .sharded_runner import compute_shards
    shards = compute_shards(reference_path, process_count, contig=contig,
                            start=start, end=end)
    return shards[process_index] if process_index < len(shards) else []


def _barrier(name):
    """Cross-process sync: a tiny psum over all processes."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    if jax.process_count() == 1:
        return
    multihost_utils.sync_global_devices(name)
    del jnp


def run_distributed(args, run_single_fn):
    """Per-process driver: run `run_single_fn(args)` restricted to this
    process's interval shard, then merge on rank 0.

    `args` is pipeline.caller.HCArgs; `run_single_fn(args)` runs the normal
    single-process pipeline honoring args.target_span/output_path.
    """
    import copy

    import jax
    rank, world = jax.process_index(), jax.process_count()
    span = None
    if args.target_span:
        from ..pipeline.caller import parse_span
        c, s, e = parse_span(args.target_span)
        span = (c, s, e)
    spans = process_shard_span(
        args.reference_path, rank, world,
        contig=span[0] if span else None,
        start=span[1] if span else None,
        end=span[2] if span else None)

    shard_files_all = []   # every rank computes the same global list
    for r in range(world):
        r_spans = process_shard_span(
            args.reference_path, r, world,
            contig=span[0] if span else None,
            start=span[1] if span else None,
            end=span[2] if span else None)
        for pi in range(len(r_spans)):
            shard_files_all.append(f"{args.output_path}.rank{r:04d}_{pi:03d}")

    stats = None
    for pi, (contig, _ps, _pe, core_s, core_e) in enumerate(spans):
        shard_args = copy.copy(args)
        shard_args.output_path = f"{args.output_path}.rank{rank:04d}_{pi:03d}"
        shard_args.target_span = f"{contig}:{core_s + 1}-{core_e}"
        stats = run_single_fn(shard_args)

    _barrier("rovaca-shards-done")
    if rank == 0:
        from .sharded_runner import merge_shard_vcfs
        merge_shard_vcfs([f for f in shard_files_all if os.path.exists(f)],
                         args.output_path,
                         compression_level=args.compression_level)
        for f in shard_files_all:
            if os.path.exists(f):
                os.unlink(f)
    _barrier("rovaca-merge-done")
    return stats
