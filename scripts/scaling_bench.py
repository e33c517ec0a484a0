"""Host-level scaling: interval-shard processes on one machine.

The BASELINE north star asks for reads/s at 1 chip / 1 host / N hosts and
>=80% efficiency at N>=2. Multi-host hardware is not present in this
environment, so this measures the host-level proxy — the same interval-
shard + ordered-merge mechanism `run_distributed` uses per rank — at
1/2/4 shard processes, and reports parallel efficiency against the
1-shard wall. On an H-core host only H-way scaling is physical; shards
beyond H document the saturation point.

Usage: python scripts/scaling_bench.py <corpusdir> [shard_counts...]
Emits <corpusdir>/SCALING.json.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    outdir = sys.argv[1]
    shard_counts = [int(x) for x in sys.argv[2:]] or [1, 2, 4]
    bam = os.path.join(outdir, "sample.bam")
    ref = os.path.join(outdir, "ref.fa")
    from rovaca_tpu.io.bam import BamReader
    n_reads = sum(1 for _ in BamReader(bam))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["ROVACA_NATIVE_THREADS"] = "1"
    env["ROVACA_PIN_SHARDS"] = "1"
    # one thread per rank: the scaling question is rank-per-core, so the
    # in-process prep thread pair (host_executor) must not oversubscribe
    env["ROVACA_PREP_THREADS"] = "1"
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.expanduser(
        "~/.cache/rovaca_jax")

    results = {"n_reads": n_reads, "ncpu": os.cpu_count(), "runs": {}}
    base_rows = None
    for s in shard_counts:
        out = os.path.join(outdir, f"scale_{s}.vcf")
        cmd = [sys.executable, "-m", "rovaca_tpu.cli", "HaplotypeCaller",
               "-i", bam, "-r", ref, "-o", out, "--pairhmm-engine", "auto"]
        if s > 1:
            cmd += ["--shards", str(s)]
        # pin the 1-shard baseline to one core: the scaling question is
        # "does a rank-per-core split scale", so the baseline is one rank
        # on one core (multi-host ranks own their cores; an unpinned
        # single process would already use the whole box via overlap
        # threads and answer a different question)
        preexec = (lambda: os.sched_setaffinity(0, {0})) if s == 1 else None
        t0 = time.perf_counter()
        cp = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=3600, preexec_fn=preexec)
        dt = time.perf_counter() - t0
        if cp.returncode != 0:
            sys.stderr.write(cp.stderr[-2000:])
            raise SystemExit(f"shards={s} failed")
        with open(out) as f:
            rows = [ln for ln in f if not ln.startswith("#")]
        if base_rows is None:
            base_rows = rows
            ident = True
        else:
            ident = rows == base_rows
        results["runs"][str(s)] = {
            "wall_s": round(dt, 2),
            "reads_per_s": round(n_reads / dt),
            "records": len(rows),
            "rows_identical_to_1shard": ident,
        }
        print(f"shards={s}: {dt:.1f}s  {n_reads/dt:.0f} reads/s"
              f"  identical={ident}", flush=True)

    # startup/compute decomposition (round-5 ask #7): measure the fixed
    # per-process startup cost S directly with a near-empty -L span, then
    # model wall(P) = S + W / min(P, ncpu) and report the residual at each
    # rank count, so the efficiency number rests on a model rather than a
    # single run pair. (Oversubscribed ranks, P > ncpu, bound the model:
    # compute can't beat ncpu-way.)
    t0 = time.perf_counter()
    cp = subprocess.run(
        [sys.executable, "-m", "rovaca_tpu.cli", "HaplotypeCaller",
         "-i", bam, "-r", ref,
         "-o", os.path.join(outdir, "scale_startup.vcf"),
         "-L", "chr20:1-2000", "--pairhmm-engine", "auto"],
        env=env, capture_output=True, text=True, timeout=600)
    startup_s = round(time.perf_counter() - t0, 2)
    results["startup_probe_s"] = (startup_s if cp.returncode == 0
                                  else None)

    one = results["runs"].get("1")
    if one:
        ncpu = os.cpu_count() or 2
        w1 = one["wall_s"] - (startup_s or 0)
        for s, r in results["runs"].items():
            r["efficiency_vs_1"] = round(
                one["wall_s"] / (r["wall_s"] * int(s)), 3)
            p_eff = min(int(s), ncpu)
            model = (startup_s or 0) + w1 / p_eff
            r["model_wall_s"] = round(model, 2)
            r["model_residual_pct"] = round(
                100.0 * (r["wall_s"] - model) / model, 1)
        results["model"] = ("wall(P) = startup + W/min(P,ncpu); "
                            "startup measured via near-empty -L run")
    path = os.path.join(outdir, "SCALING.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print("->", path)


if __name__ == "__main__":
    main()
