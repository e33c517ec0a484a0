"""Interval-sharded multi-process/multi-host run driver.

The BASELINE north star: FASTA replicated per host, genomic intervals sharded
data-parallel, per-shard VCF streams merged in coordinate order (the
reference's source_id-ordered writer merge — reference: src/haplotypecaller/
writer/writer.cpp:147-196 — lifted to shard granularity).

Each shard is an independent CLI invocation restricted to its core span with
boundary context; shard outputs concatenate in genome order (a shard only
emits records whose start lies in its core span, so the merge is exact).
Shards run as local subprocesses. On a GPU host each one sees exactly one
card (CUDA_VISIBLE_DEVICES) and at most one runs per card, because a JAX
process reserves most of a card's memory; further shards wait for a card.
Under JAX_PLATFORMS=cpu all shards run at once.
"""

import os
import subprocess
import sys
import time

from ..io.fasta import FastaFile
from .sharding import shard_intervals


def compute_shards(reference_path, n_shards, contig=None, start=None,
                   end=None):
    """Shard (contig, core_start, core_end) spans by base count."""
    fasta = FastaFile(reference_path)
    if contig is not None:
        intervals = [(contig, start or 0,
                      end or fasta.contig_length(contig))]
    else:
        intervals = [(c, 0, length)
                     for c, length in fasta.contig_dict.items()]
    return shard_intervals(intervals, n_shards)


def visible_cards():
    """Ids of the GPUs this process may hand out: CUDA_VISIBLE_DEVICES when
    set, else the cards nvidia-smi lists ([] when there is none)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    try:
        cp = subprocess.run(["nvidia-smi", "--query-gpu=index",
                             "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if cp.returncode != 0:
        return []
    return [ln.strip() for ln in cp.stdout.splitlines() if ln.strip()]


def run_processes(argvs, env, cards=None, preexec=None):
    """Run each argv as a subprocess and wait for all of them.

    With `cards`, every process gets one card as its only visible device
    and at most one process runs per card; the others queue until a card
    is free. Without cards all start at once. `preexec(k)` optionally
    returns a preexec_fn for the k-th process. Raises RuntimeError naming
    the first process that failed."""
    free = None if cards is None else list(cards)
    if free is not None and not free:
        raise ValueError("run_processes: empty card list")
    queue = list(enumerate(argvs))
    running = {}      # Popen -> card
    failed = []
    while queue or running:
        while queue and (free is None or free):
            k, argv = queue.pop(0)
            penv = dict(env)
            card = None
            if free is not None:
                card = free.pop(0)
                penv["CUDA_VISIBLE_DEVICES"] = card
            proc = subprocess.Popen(
                argv, env=penv,
                preexec_fn=preexec(k) if preexec is not None else None)
            running[proc] = card
        done = [p for p in running if p.poll() is not None]
        if not done:
            time.sleep(0.05)
            continue
        for proc in done:
            card = running.pop(proc)
            if proc.returncode != 0:
                failed.append(proc.args)
            if free is not None:
                free.append(card)
    if failed:
        raise RuntimeError(f"shard process failed: {failed[0]}")


def run_sharded(cli_args, n_shards, output_path):
    """Run the HaplotypeCaller CLI once per shard and merge outputs.

    cli_args: the argv list WITHOUT -o/-L (they're added per shard).
    Returns the list of per-shard record counts.
    """
    from ..ops.pairhmm.api import NoDeviceError
    from ..utils.platform import pinned_to_cpu

    ref = cli_args[cli_args.index("-r") + 1] if "-r" in cli_args else \
        cli_args[cli_args.index("--reference") + 1]
    shards = compute_shards(ref, n_shards)
    cards = None
    if not pinned_to_cpu():
        cards = visible_cards()
        if not cards:
            raise NoDeviceError("--shards found no GPU; set "
                                "JAX_PLATFORMS=cpu to run shards on the host")

    # index every input BAM once up front so each shard's -L becomes an
    # indexed seek instead of a whole-file scan (the reference hands each
    # worker an hts_itr over the shared index; here the .bai is the shared
    # structure and shard processes open it read-only)
    for flag in ("-i", "--input"):
        for k, a in enumerate(cli_args):
            if a == flag and k + 1 < len(cli_args):
                bam = cli_args[k + 1]
                from ..io.bai import build_index, find_index
                if find_index(bam) is None:
                    try:
                        build_index(bam)
                    except (ValueError, OSError):
                        pass  # unindexable input: shards fall back to scans

    argvs = []
    shard_files = []
    for si, shard in enumerate(shards):
        # one invocation per contiguous span in the shard
        for pi, (contig, _ps, _pe, core_s, core_e) in enumerate(shard):
            out = f"{output_path}.shard{si:04d}_{pi:03d}"
            shard_files.append(out)
            argvs.append([sys.executable, "-m", "rovaca_tpu.cli",
                          "HaplotypeCaller", *cli_args, "-o", out,
                          "-L", f"{contig}:{core_s + 1}-{core_e}"])
    preexec = None
    if cards is None and os.environ.get("ROVACA_PIN_SHARDS"):
        # ROVACA_PIN_SHARDS: give each CPU shard its own core, like a
        # multi-host rank owns its host. Without pinning, N workers
        # x (XLA pool + OMP + overlap thread) oversubscribe an N-core box.
        ncpu = os.cpu_count() or 1
        preexec = (lambda k: (lambda c=k % ncpu:
                              os.sched_setaffinity(0, {c})))
    # shard processes import this package from where this process did
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    run_processes(argvs, env, cards=cards, preexec=preexec)

    counts = merge_shard_vcfs(shard_files, output_path)
    for f in shard_files:
        os.unlink(f)
    return counts


def _open_vcf_lines(path):
    """Iterate text lines of a plain or BGZF/gzip-compressed VCF."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import io

        from ..io import bgzf
        fh = io.TextIOWrapper(bgzf.open_read(path))
    else:
        fh = open(path)
    return fh


def merge_shard_vcfs(shard_files, output_path, compression_level=6):
    """Coordinate-ordered merge: header from shard 0, bodies concatenated
    (shards are genome-ordered and emit only their core span).

    BGZF-aware on both sides: shard inputs may be plain or compressed, and
    a `.gz` output is written as true BGZF and re-indexed with a fresh .tbi
    (mirrors the unsharded writer's close path, reference writer.cpp:97-98)."""
    counts = []
    if output_path.endswith(".gz"):
        import io

        from ..io import bgzf
        from ..io.vcf import _BgzfRaw
        out = io.TextIOWrapper(_BgzfRaw(bgzf.Writer(output_path,
                                                    compression_level)))
    else:
        out = open(output_path, "w")
    try:
        wrote_header = False
        for path in shard_files:
            n = 0
            with _open_vcf_lines(path) as fh:
                for line in fh:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                        continue
                    out.write(line)
                    n += 1
            wrote_header = True
            counts.append(n)
    finally:
        out.close()
    if output_path.endswith(".gz"):
        from ..io import tabix
        tabix.build_index(output_path)
    return counts


