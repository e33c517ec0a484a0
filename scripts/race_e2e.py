"""End-to-end race: reference binary vs ours (GPU default / host CPU).

MEASUREMENT PROTOCOL (round-5): every contender runs N times (default 5),
INTERLEAVED round-robin so that slow drift of this shared 2-vCPU VM hits
all contenders equally; the headline number is the per-contender MEDIAN
wall with the full run array recorded. Runs are strictly sequential (never
two heavy drives at once on this 2-core host). Output equivalence is
diffed once, field-level, against the reference binary's output.

Note on the sharded contender: reservoir downsampling consumes a Java-LCG
stream in traversal order (reference: src/common/downsampler_hc.h:94-210),
so an interval-split run picks different survivors at >50-deep alignment
starts than a whole-contig run — exactly as the reference binary does under
-L interval splits. A DIVERGENT diff for *_2shard that is limited to
depth/qual fields at saturated pileups is this known semantic, not a bug
(the unsharded contenders must MATCH).

Usage: python scripts/race_e2e.py <outdir> [genome_len] [coverage] [seed]
                                  [n_runs]
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

REF_BIN = os.path.join(REPO, ".refbuild", "ref", "build-dev", "bin",
                       "rovaca")


def parse_vcf_records(path):
    """{(contig, pos, ref, alts): (line_fields, DP)} over a VCF file."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            key = (f[0], int(f[1]), f[3], f[4])
            dp = 0
            for kv in f[7].split(";"):
                if kv.startswith("DP="):
                    dp = int(kv[3:])
            out[key] = (f, dp)
    return out


def _downsampled_hotspots(bam_path, target=50):
    """{contig: sorted positions whose raw alignment-start count exceeds
    the positional-downsampler reservoir} — the places where a traversal
    split reseeds the LCG stream and survivor sets legitimately differ."""
    from collections import Counter
    from rovaca_tpu.io.bam import BamReader
    counts = {}
    for r in BamReader(bam_path):
        counts.setdefault(r.contig, Counter())[r.pos] += 1
    return {c: sorted(p for p, n in cnt.items() if n > target)
            for c, cnt in counts.items()}


def depth_masked_diff(unsharded_path, sharded_path, bam_path=None,
                      max_depth=50, reach=400):
    """Verify the sharded-vs-unsharded divergence is CONFINED to
    reservoir-downsampled pileups: records may differ only at sites where
    either side reports DP >= max_depth, or (when the BAM is given) within
    `reach` bp of a raw alignment-start hotspot the positional downsampler
    truncated — a site's own output DP can be small while its active
    region still contains reads whose survivor set depends on the LCG
    stream (read span + region padding; the traversal-split stream picks
    different survivors there, exactly as the reference does under -L
    splits; see module docstring). Returns (ok, detail)."""
    import bisect
    a = parse_vcf_records(unsharded_path)
    b = parse_vcf_records(sharded_path)
    hot = (_downsampled_hotspots(bam_path, max_depth)
           if bam_path else {})

    def near_hotspot(contig, pos1):
        ps = hot.get(contig)
        if not ps:
            return False
        p0 = pos1 - 1
        i = bisect.bisect_left(ps, p0 - reach)
        return i < len(ps) and ps[i] <= p0 + reach

    bad = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if ra is not None and rb is not None and ra[0] == rb[0]:
            continue
        dp = max(ra[1] if ra else 0, rb[1] if rb else 0)
        if dp < max_depth and not near_hotspot(key[0], key[1]):
            bad.append((key, "missing" if ra is None or rb is None
                        else "fields", dp))
    if bad:
        return False, f"DIVERGENT beyond depth mask: {bad[:5]}"
    n_deep = sum(1 for key in set(a) & set(b) if a[key][0] != b[key][0])
    return True, f"MATCH (depth-masked; {n_deep} deep-pileup sites differ)"


def _run(cmd, env=None, tag=""):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=3600)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise SystemExit(f"{tag} failed rc={r.returncode}")
    return dt


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _contenders(outdir, bam, fa):
    """name -> (cmd, env) for every contender."""
    base_env = dict(os.environ)
    base_env["ROVACA_NATIVE_THREADS"] = "2"

    ref_env = dict(os.environ)
    ref_env["LD_LIBRARY_PATH"] = os.path.dirname(REF_BIN)

    def ours(name, platforms=None, shards=0, gvcf=False, workers=1):
        env = dict(base_env)
        if platforms:
            env["JAX_PLATFORMS"] = platforms
        out = os.path.join(outdir, f"{name}.vcf")
        cmd = [sys.executable, "-m", "rovaca_tpu.cli", "HaplotypeCaller",
               "-i", bam, "-r", fa, "-o", out, "--pairhmm-engine", "auto"]
        if gvcf:
            cmd += ["--emit-ref-confidence", "GVCF"]
        if shards:
            cmd += ["--shards", str(shards)]
            env["ROVACA_NATIVE_THREADS"] = "1"
        if workers > 1:
            cmd += ["-t", str(workers)]
            env["ROVACA_NATIVE_THREADS"] = "1"
        return name, cmd, env, gvcf, shards

    skip = set(filter(None, os.environ.get(
        "ROVACA_RACE_SKIP", "").split(",")))
    return [c for c in [
        ("reference_avx",
         [REF_BIN, "HaplotypeCaller", "-I", bam, "-R", fa,
          "-O", os.path.join(outdir, "ref.vcf"), "--nthreads", "2"],
         ref_env, False, 0),
        ("reference_avx_gvcf",
         [REF_BIN, "HaplotypeCaller", "-I", bam, "-R", fa,
          "-O", os.path.join(outdir, "ref.g.vcf"),
          "--emit-ref-confidence", "GVCF", "--nthreads", "2"],
         ref_env, True, 0),
        ours("ours_gpu"),
        ours("ours_cpu", platforms="cpu"),
        ours("ours_cpu_gvcf", platforms="cpu", gvcf=True),
        ours("ours_gpu_gvcf", gvcf=True),
        ours("ours_cpu_2shard", platforms="cpu", shards=2),
        ours("ours_cpu_workers2", platforms="cpu", workers=2),
    ] if c[0] not in skip]


def main():
    outdir = sys.argv[1]
    genome_len = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    coverage = int(sys.argv[3]) if len(sys.argv) > 3 else 30
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 424242
    n_runs = int(sys.argv[5]) if len(sys.argv) > 5 else 5

    ge = os.path.join(REPO, "scripts", "golden_e2e.py")
    bam = os.path.join(outdir, "sample.bam")
    fa = os.path.join(outdir, "ref.fa")
    if not os.path.exists(bam):
        _run([sys.executable, ge, "gen", outdir, str(genome_len),
              str(coverage), str(seed)], tag="gen")
    from rovaca_tpu.io.bam import BamReader
    n_reads = sum(1 for _ in BamReader(bam))

    contenders = _contenders(outdir, bam, fa)
    walls = {name: [] for name, *_ in contenders}

    # interleaved rounds: VM drift hits every contender equally
    for rnd in range(n_runs):
        for name, cmd, env, _gvcf, _shards in contenders:
            dt = _run(cmd, env=env, tag=name)
            walls[name].append(round(dt, 2))
            print(f"[round {rnd + 1}/{n_runs}] {name}: {dt:.2f}s",
                  flush=True)

    results = {"genome_len": genome_len, "coverage": coverage,
               "seed": seed, "n_reads": n_reads, "n_runs": n_runs,
               "protocol": "interleaved round-robin, median-of-N walls",
               "contenders": {}}
    for name, cmd, env, gvcf, shards in contenders:
        med = _median(walls[name])
        results["contenders"][name] = {
            "wall_s": round(med, 2),
            "runs_s": walls[name],
            "spread_s": [min(walls[name]), max(walls[name])],
            "reads_per_s": round(n_reads / med)}

    # output equivalence: diff each of ours vs the reference output once
    import shutil
    for name, cmd, env, gvcf, shards in contenders:
        if name.startswith("reference"):
            continue
        out = os.path.join(outdir, f"{name}.vcf")
        shutil.copyfile(out, os.path.join(
            outdir, "ours.g.vcf" if gvcf else "ours.vcf"))
        cp = subprocess.run(
            [sys.executable, ge, "diff", outdir]
            + (["--gvcf"] if gvcf else []), capture_output=True, text=True)
        tail = cp.stdout.strip().splitlines()
        results["contenders"][name]["diff_vs_ref"] = (
            tail[-1] if tail else f"diff rc={cp.returncode}")
        if shards:
            ok, detail = depth_masked_diff(
                os.path.join(outdir, "ours_cpu.vcf"), out, bam_path=bam)
            results["contenders"][name]["diff_vs_unsharded"] = detail
            if not ok:
                print(f"WARNING {name}: {detail}", flush=True)

    ref_t = results["contenders"]["reference_avx"]["wall_s"]
    ref_gt = results["contenders"]["reference_avx_gvcf"]["wall_s"]
    for k, v in results["contenders"].items():
        base = ref_gt if k.endswith("gvcf") else ref_t
        v["vs_reference"] = round(base / v["wall_s"], 3)
    path = os.path.join(outdir, "RACE.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["contenders"], indent=1))
    print("->", path)


if __name__ == "__main__":
    main()
