"""Smoke test of the GPU path: the card, the PairHMM kernel, and the caller.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card: phases 1-3
    python chip_smoke.py --four-cards  # four cards: phase 4 only

1. Device: JAX's first device must be a GPU; prints its kind, the device
   count and the card's name and power limit from nvidia-smi. Then builds
   the native libraries and the kernel's library, so that no timed run
   below pays for a compiler.
2. Kernel: launches of 150 bp reads (Lr 192) against 300-500 bp haplotypes
   (Lh 384 and 512) at each G of the launch ladder (64, 256, 1024); a
   quarter of the reads are noisy enough to fall on both sides of the
   float32 rescue threshold. For each, prints compiled.memory_analysis()
   of the CUDA kernel and of the XLA scan of the same launch, their warm
   times (median of 3) and compares them pair by pair; at G = 1024 every
   pair is also compared with the native float32 host engine and a sample,
   weighted to the rescue threshold, with the float64 numpy oracle.
3. End to end: a synthetic diploid 1 Mb contig at 30x (2x150 bp pairs, het
   SNPs and 1-6 bp indels at about 1/kb) through rovaca_tpu.cli.main in
   this process, VCF and GVCF, which must score PairHMM on the card; then
   the same inputs on the host path in a child process pinned to the CPU.
   Records, genotypes and GVCF blocks must match.
4. --four-cards: a 1-card run (child), `--shards 4` with one card per shard
   process, and a plain run over all four cards in this process; both must
   match the 1-card output.

Any failed phase exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

RTOL = 2e-4       # float32 against float32 (or float64), summation order
HAP_LENS = ((300, 376), (400, 500))   # haplotype lengths: Lh 384 and 512
LADDER_G = (64, 256, 1024)            # PairHMMScheduler.G_LADDER
NOISY = 0.25      # share of reads whose probabilities straddle the rescue
LIK_TOL = {"QUAL": 0.02, "QD": 0.02, "GQ": 1, "PL": 1}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    cp = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"],
                        capture_output=True, text=True, timeout=60)
    check(cp.returncode == 0, f"nvidia-smi failed: {cp.stderr.strip()}")
    return cp.stdout.strip()


class CompileCounter:
    """Counts XLA backend compilations in this process."""

    def __init__(self):
        import jax
        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def device_phase():
    import jax
    devices = jax.devices()
    dev = devices[0]
    check(dev.platform == "gpu",
          f"JAX device is {dev.platform!r}, not a GPU")
    print(f"device: {dev.device_kind} platform={dev.platform} "
          f"count={len(devices)}")
    print(f"card: {card_line()}", flush=True)
    return dev, len(devices)


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------

NATIVE_LIBS = ("activity_native", "assemble_native", "bamscan_native",
               "finalize_native", "pairhmm_native", "pcr_native",
               "posobs_native", "prepare_native", "refconf_native",
               "sw_native")


def build_phase():
    """Build the native host libraries (g++) and the kernel's library (nvcc)
    into build/native/ before any timed run: a fresh checkout compiles them
    once per host, which would otherwise land in the first run's wall."""
    import importlib

    from rovaca_tpu.ops.pairhmm import cuda
    t0 = time.perf_counter()
    for name in NATIVE_LIBS:
        mod = importlib.import_module(f"rovaca_tpu.native.{name}")
        check(mod.available(), f"native library {name} did not build")
    from rovaca_tpu.native import pairhmm_native
    check(pairhmm_native.rescue_available(), "float64 rescue did not build")
    cuda.library()
    print(f"builds: native libraries and the CUDA kernel ready in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def timed(compiled, dargs, reps=3):
    """Output and median warm time of `reps` calls of a compiled launch."""
    out = compiled(*dargs)
    out.block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        compiled(*dargs).block_until_ready()
        times.append(time.perf_counter() - t0)
    return np.asarray(out), float(np.median(times))


def compare_raw(got, want, what):
    """Raw probabilities of the same pairs from two engines. Pairs under
    MIN_ACCEPTED_F32 on both sides go to the float64 rescue and are not
    compared; every other pair must agree within RTOL, so the two engines
    send the same pairs to the rescue unless a pair lies within RTOL of the
    threshold. Returns (max rel err, pairs below on both, threshold flips)."""
    from rovaca_tpu import constants as C
    lo = np.asarray(C.MIN_ACCEPTED_F32, np.float32)
    top = np.maximum(got, want)
    scored = top >= lo
    rel = float((np.abs(got - want)[scored] / top[scored]).max())
    check(rel <= RTOL, f"{what}: max rel err {rel:.3g} > {RTOL}")
    return rel, int((~scored).sum()), int(((got < lo) != (want < lo)).sum())


def kernel_phase(compiles, n_oracle=24, n_edge=12):
    import jax
    import simdata

    from rovaca_tpu import constants as C
    from rovaca_tpu.native import pairhmm_native
    from rovaca_tpu.ops.pairhmm import golden, prep
    from rovaca_tpu.ops.pairhmm.compact import pairhmm_indexed_compact
    from rovaca_tpu.ops.pairhmm.cuda import pairhmm_cuda_indexed

    rng = np.random.default_rng(7)
    lo = C.MIN_ACCEPTED_F32
    for hap_len in HAP_LENS:
        for g in LADDER_G:
            jobs, spans, args = simdata.pairhmm_launch(rng, g, hap_len,
                                                       noisy=NOISY)
            lr, lh = args[0].shape[1], args[5].shape[1]
            shape = f"Lr={lr} Lh={lh} G={g}"
            dargs = tuple(jax.device_put(a) for a in args)
            outs, secs, comp = {}, {}, {}
            for name, fn in (("kernel", pairhmm_cuda_indexed),
                             ("xla", pairhmm_indexed_compact)):
                t0 = time.perf_counter()
                compiled = fn.lower(*dargs).compile()
                comp[name] = time.perf_counter() - t0
                print(f"memory_analysis {name} {shape}: "
                      f"{compiled.memory_analysis()}", flush=True)
                outs[name], secs[name] = timed(compiled, dargs)
            out = outs["kernel"]
            check(out.shape == (g, 8, 128) and np.isfinite(out).all(),
                  f"{shape}: kernel output shape {out.shape} or non-finite "
                  "values")
            real = np.concatenate([np.arange(sp.start, sp.stop)
                                   for sp in spans])
            check(np.all(out[spans[-1].stop:] == 0),
                  f"{shape}: unused pair slots not zero")
            rel_x, under, flips = compare_raw(out[real], outs["xla"][real],
                                              f"{shape} kernel vs XLA")
            cells = sum(len(r.bases) * len(h) for j in jobs for r in j.reads
                        for h in j.haps)
            print(f"kernel {shape}: warm kernel {secs['kernel'] * 1e3:.2f} "
                  f"ms ({cells / secs['kernel'] / 1e9:.0f} Gcells/s) vs XLA "
                  f"scan {secs['xla'] * 1e3:.1f} ms "
                  f"({secs['xla'] / secs['kernel']:.1f}x); compile kernel "
                  f"{comp['kernel']:.2f}s, XLA {comp['xla']:.2f}s; vs XLA "
                  f"max rel err {rel_x:.3g}, {under} pairs below {lo:g} on "
                  f"both, {flips} threshold flips", flush=True)
            if g != LADDER_G[-1]:
                continue

            # the full launch: every pair against the native float32
            # engine, a sample against the float64 oracle
            got_all, want_all, oracle = [], [], []
            for job, span in zip(jobs, spans):
                b = job.batch
                got = b.result_matrix(out[span].reshape(b.gh, b.gr, 8, 128))
                dense = prep.build_pair_batch(job.reads, job.haps)
                want = dense.result_matrix(pairhmm_native.pairhmm_dense(
                    dense.trans, dense.rbase, dense.rlen, dense.hbase,
                    dense.hlen))
                got_all.append(got.ravel())
                want_all.append(want.ravel())
                oracle.append((job, got))
            got_all = np.concatenate(got_all)
            rel_n, under, flips = compare_raw(got_all,
                                              np.concatenate(want_all),
                                              f"{shape} kernel vs native")
            n_below = int((got_all < lo).sum())
            check(0 < n_below < got_all.size,
                  f"{shape}: {n_below} of {got_all.size} pairs below {lo:g}; "
                  "the rescue threshold is not covered")

            # float64 oracle: a random sample, and pairs within a factor of
            # 100 of the threshold, whose rescue decision it must confirm
            near = [(k, h, r) for k, (_, got) in enumerate(oracle)
                    for h, r in zip(*np.nonzero((got > lo / 100)
                                                & (got < lo * 100)))]
            picks = [near[int(i)] for i in rng.permutation(len(near))[:n_edge]]
            for _ in range(n_oracle):
                k = int(rng.integers(len(oracle)))
                job = oracle[k][0]
                picks.append((k, int(rng.integers(len(job.haps))),
                              int(rng.integers(len(job.reads)))))
            worst64, n_edge_seen = 0.0, 0
            for k, h, r in picks:
                job, got = oracle[k]
                read = job.reads[r]
                p64 = golden.compute_full_prob(
                    read.bases, read.quals, read.mapping_quality,
                    job.haps[h], dtype=np.float64)
                # the float64 result on the float32 scale
                raw64 = float(p64) * (C.INITIAL_CONSTANT_F32
                                      / C.INITIAL_CONSTANT_F64)
                err = abs(float(got[h, r]) / raw64 - 1.0)
                if max(raw64, float(got[h, r])) >= lo:
                    worst64 = max(worst64, err)
                if lo / 100 < got[h, r] < lo * 100:
                    n_edge_seen += 1
                    check((got[h, r] < lo) == (raw64 < lo) or err <= RTOL,
                          f"{shape}: rescue decision differs from the "
                          f"float64 oracle ({got[h, r]:.4g} vs {raw64:.4g})")
            check(worst64 <= RTOL, f"{shape}: kernel vs float64 oracle max "
                                   f"rel err {worst64:.3g} > {RTOL}")
            print(f"kernel {shape} vs native f32, all {got_all.size} pairs: "
                  f"max rel err {rel_n:.3g}, {n_below} below {lo:g} "
                  f"(rescued in float64), {flips} threshold flips; vs f64 "
                  f"oracle ({len(picks)} pairs, {n_edge_seen} within 100x "
                  f"of {lo:g}) max rel err {worst64:.3g}, rescue decisions "
                  f"agree; tolerance {RTOL}; compiles so far {compiles.n}",
                  flush=True)


# ---------------------------------------------------------------------------
# phase 3 / 4 data and comparison
# ---------------------------------------------------------------------------

def make_corpus(outdir, genome_len=1_000_000, coverage=30, read_len=150,
                seed=20261016):
    """Diploid contig: hap1 = reference, hap2 = reference + het SNPs and
    1-6 bp indels about every kb; 2 x read_len pairs at `coverage`."""
    import simdata
    from rovaca_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    ref = simdata.random_ref(rng, genome_len)
    variants = []
    pos = 500
    while pos < genome_len - 600:
        kind = rng.choice(["snp", "snp", "ins", "del"])
        if kind == "snp":
            alt = "ACGT"[("ACGT".index(ref[pos]) + int(rng.integers(1, 4)))
                         % 4]
            variants.append((pos, ref[pos], alt))
        elif kind == "ins":
            n = int(rng.integers(1, 7))
            variants.append((pos, ref[pos],
                             ref[pos] + simdata.random_ref(rng, n)))
        else:
            n = int(rng.integers(1, 7))
            variants.append((pos, ref[pos:pos + n + 1], ref[pos]))
        pos += int(rng.integers(500, 1500))
    hap2 = simdata.apply_variants(ref, variants)
    n_frags = coverage * genome_len // (2 * read_len) // 2
    reads = []
    for name, hap in (("h1_", ref), ("h2_", hap2)):
        reads += simdata.simulate_fragments(
            rng, ref, hap, "chr1", n_frags, read_len=read_len,
            frag_mean=400, frag_sd=80, name_prefix=name, hotspot_rate=0.0)
    reads.sort(key=lambda r: r.pos)
    fasta = os.path.join(outdir, "ref.fa")
    bam = os.path.join(outdir, "sample.bam")
    write_fasta(fasta, {"chr1": ref})
    simdata.write_test_bam(bam, reads, "chr1", genome_len,
                           read_groups=("rg1", "rg2"))
    print(f"corpus: {genome_len} bp, {len(reads)} reads of {read_len} bp, "
          f"{len(variants)} het variants", flush=True)
    return fasta, bam


def vcf_rows(path):
    rows = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                rows.append(line.rstrip("\n").split("\t"))
    return rows


def _close(key, a, b):
    tol = LIK_TOL[key]
    try:
        return all(abs(float(x) - float(y)) <= tol + 1e-9
                   for x, y in zip(a.split(","), b.split(",")))
    except ValueError:
        return False


def compare_vcfs(path_a, path_b):
    """Compare two VCF/GVCF outputs. Everything must be identical except
    the likelihood-derived fields QUAL, QD, GQ and PL, which may differ by
    one unit in their printed precision (LIK_TOL): the engines are float32
    with different summation order, so a rounded value can move by one
    step. Returns the number of such differing fields; raises on any other
    difference."""
    a, b = vcf_rows(path_a), vcf_rows(path_b)
    check(len(a) == len(b), f"{len(a)} vs {len(b)} records "
                            f"({os.path.basename(path_a)} vs "
                            f"{os.path.basename(path_b)})")
    n_lik = 0
    for ra, rb in zip(a, b):
        where = f"{ra[0]}:{ra[1]}"
        check(ra[:5] == rb[:5] and ra[6] == rb[6] and ra[8] == rb[8],
              f"record differs at {where}: {ra[:9]} vs {rb[:9]}")
        if ra[5] != rb[5]:
            check(_close("QUAL", ra[5], rb[5]), f"QUAL at {where}")
            n_lik += 1
        ia = dict(kv.split("=", 1) if "=" in kv else (kv, "")
                  for kv in ra[7].split(";"))
        ib = dict(kv.split("=", 1) if "=" in kv else (kv, "")
                  for kv in rb[7].split(";"))
        check(ia.keys() == ib.keys(), f"INFO keys at {where}")
        for k in ia:
            if ia[k] != ib[k]:
                check(k in LIK_TOL and _close(k, ia[k], ib[k]),
                      f"INFO {k} at {where}: {ia[k]} vs {ib[k]}")
                n_lik += 1
        keys = ra[8].split(":")
        for k, x, y in zip(keys, ra[9].split(":"), rb[9].split(":")):
            if x != y:
                check(k in LIK_TOL and _close(k, x, y),
                      f"FORMAT {k} at {where}: {x} vs {y}")
                n_lik += 1
    return n_lik


class CounterLog(logging.Handler):
    """Collects the caller's end-of-run counters from its log."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.counters = {}

    def emit(self, record):
        if record.msg.startswith("counter "):
            key, value = record.args
            self.counters[key] = value


def run_cli(argv, counters):
    from rovaca_tpu import cli
    from rovaca_tpu.utils import logging as rlog
    rlog.init("INFO")
    handler = CounterLog()
    rlog.logger.addHandler(handler)
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        rlog.logger.removeHandler(handler)
    check(rc == 0, f"cli.main returned {rc} for {argv}")
    counters.update(handler.counters)
    return wall


def run_child(argv, env_extra):
    env = dict(os.environ, **env_extra)
    t0 = time.perf_counter()
    cp = subprocess.run([sys.executable, "-m", "rovaca_tpu.cli", *argv],
                        env=env, cwd=HERE, capture_output=True, text=True)
    check(cp.returncode == 0,
          f"child run failed ({cp.returncode}): {cp.stderr[-2000:]}")
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def e2e_phase(workdir, compiles, genome_len=1_000_000):
    fasta, bam = make_corpus(workdir, genome_len=genome_len)
    host_env = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    for mode, extra in (("VCF", []), ("GVCF", ["-e", "GVCF"])):
        suffix = ".g.vcf" if extra else ".vcf"
        dev_out = os.path.join(workdir, "gpu" + suffix)
        host_out = os.path.join(workdir, "host" + suffix)
        base = ["HaplotypeCaller", "-i", bam, "-r", fasta, *extra,
                "--log-level", "WARNING"]
        counters = {}
        wall = run_cli(base + ["-o", dev_out], counters)
        launches = counters.get("pairhmm_device_launches", 0)
        natives = counters.get("pairhmm_native_calls", 0)
        check(launches > 0, f"{mode}: no PairHMM launches on the card")
        check(natives == 0, f"{mode}: {natives} native PairHMM calls")
        host_wall = run_child(base + ["-o", host_out], host_env)
        n_lik = compare_vcfs(dev_out, host_out)
        print(f"e2e {mode}: {len(vcf_rows(dev_out))} records match the host "
              f"path ({n_lik} likelihood fields within {LIK_TOL}); "
              f"{launches} device launches scoring "
              f"{counters.get('pairhmm_device_pairs', 0)} pairs, "
              f"{natives} native calls; wall {wall:.1f}s on the card, "
              f"{host_wall:.1f}s host; compiles so far {compiles.n}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def four_cards_phase(workdir, genome_len=1_000_000):
    fasta, bam = make_corpus(workdir, genome_len=genome_len)
    base = ["HaplotypeCaller", "-i", bam, "-r", fasta,
            "--log-level", "WARNING"]
    one = os.path.join(workdir, "one.vcf")
    sharded = os.path.join(workdir, "shards4.vcf")
    plain = os.path.join(workdir, "plain4.vcf")
    t_one = run_child(base + ["-o", one], {"CUDA_VISIBLE_DEVICES": "0"})
    # this process has not touched JAX yet, so every shard can take a card
    counters = {}
    t_sh = run_cli(base + ["-o", sharded, "--shards", "4"], counters)
    t_pl = run_cli(base + ["-o", plain], counters)
    check(counters.get("pairhmm_device_launches", 0) >= 4,
          "plain run made fewer launches than cards")
    n_sh = compare_vcfs(sharded, one)
    n_pl = compare_vcfs(plain, one)
    print(f"four cards: --shards 4 matches 1 card ({n_sh} likelihood "
          f"fields within {LIK_TOL}); plain 4-card run matches 1 card "
          f"({n_pl}); {len(vcf_rows(one))} records; walls 1 card "
          f"{t_one:.1f}s, shards {t_sh:.1f}s, plain {t_pl:.1f}s",
          flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card phase")
    a = p.parse_args()

    from rovaca_tpu.utils.platform import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            if a.four_cards:
                four_cards_phase(work)
                dev, count = device_phase()
                check(count == 4, f"{count} devices visible, not 4")
            else:
                dev, count = device_phase()
                build_phase()
                compiles = CompileCounter()
                kernel_phase(compiles)
                e2e_phase(work, compiles)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
