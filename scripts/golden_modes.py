"""Golden gates for the remaining input modes vs the reference binary.

Each mode generates a corpus exercising one input path, runs BOTH the
reference executable and our CLI on identical inputs, and field-diffs the
outputs via golden_e2e.diff:

  multicontig  three contigs of different lengths in one FASTA + BAM
  multibam     reads split across two BAMs (k-way merge input)
  dbsnp        tabix-indexed dbSNP VCF wired to the ID column (--check-id)
  bed          BED targets with -P padding (WES mode)

Usage: python scripts/golden_modes.py <mode|all> <workdir> [seed]
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

REF_BIN = os.path.join(REPO, ".refbuild", "ref", "build-dev", "bin",
                       "rovaca")


def _gen_contig(rng, length, contig, name_prefix):
    """(ref_str, reads, truth) for one contig (golden_e2e.generate model)."""
    import simdata
    ref = simdata.random_ref(rng, length)
    n_var = max(6, length // 2500)
    positions = np.sort(rng.choice(np.arange(500, length - 500),
                                   size=n_var, replace=False))
    keep = [positions[0]]
    for p in positions[1:]:
        if p - keep[-1] > 120:
            keep.append(p)
    truth = []
    for pos in keep:
        base = ref[pos]
        zyg = "het" if rng.random() < 0.6 else "hom"
        r = rng.random()
        if r < 0.65:
            alt = rng.choice([b for b in "ACGT" if b != base])
            var = (pos, base, str(alt))
        elif r < 0.85:
            ins = "".join(rng.choice(list("ACGT"),
                                     size=int(rng.integers(1, 7))))
            var = (pos, base, base + ins)
        else:
            dlen = int(rng.integers(1, 9))
            var = (pos, ref[pos:pos + dlen + 1], base)
        truth.append((var, zyg))
    hom_vars = sorted(v for v, z in truth if z == "hom")
    all_vars = sorted(v for v, z in truth)
    hap1 = simdata.apply_variants(ref, hom_vars)
    hap2 = simdata.apply_variants(ref, all_vars)
    n_frags = 30 * length // (2 * 100) // 2
    reads = (simdata.simulate_fragments(rng, ref, hap1, contig, n_frags,
                                        name_prefix=f"{name_prefix}h1_")
             + simdata.simulate_fragments(rng, ref, hap2, contig, n_frags,
                                          name_prefix=f"{name_prefix}h2_"))
    return ref, reads, truth


def _write_multi_bam(path, reads_by_contig, sample="NA12878",
                     read_groups=("rg1",), presorted=False):
    """Coordinate-sorted BAM over several contigs."""
    from rovaca_tpu.io.bam import BamHeader, BamWriter
    from rovaca_tpu.io.bai import build_index
    names = [c for c, _, _ in reads_by_contig]
    lens = [ln for _, ln, _ in reads_by_contig]
    rg_lines = "".join(f"@RG\tID:{rg}\tSM:{sample}\n" for rg in read_groups)
    sq = "".join(f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in zip(names, lens))
    header = BamHeader(f"@HD\tVN:1.6\tSO:coordinate\n{sq}{rg_lines}",
                       names, lens)
    all_reads = []
    for tid, (contig, _ln, reads) in enumerate(reads_by_contig):
        for r in reads:
            r.ref_id = tid
            r.contig = contig
            if r.mate_ref_id != -1:
                r.mate_ref_id = tid
            r.tags.setdefault("RG", read_groups[0])
            all_reads.append(r)
    if not presorted:
        all_reads.sort(key=lambda r: (r.ref_id, r.pos))
    with BamWriter(path, header) as w:
        for r in all_reads:
            w.write(r)
    build_index(path)


def _write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
    fai = []
    off = 0
    for name, seq in contigs:
        off += len(name) + 2
        n = len(seq)
        nl = -(-n // 70)
        fai.append(f"{name}\t{n}\t{off}\t70\t71\n")
        off += n + nl
    with open(path + ".fai", "w") as f:
        f.writelines(fai)


def _run_both_and_diff(workdir, ref_extra, ours_extra, diff_extra=(),
                       bam_args_ref=None, bam_args_ours=None):
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = os.path.dirname(REF_BIN)
    bam_ref = bam_args_ref or ["-I", os.path.join(workdir, "sample.bam")]
    r = subprocess.run(
        [REF_BIN, "HaplotypeCaller", *bam_ref,
         "-R", os.path.join(workdir, "ref.fa"),
         "-O", os.path.join(workdir, "ref.vcf"),
         "--nthreads", "2", *ref_extra],
        env=env, capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise SystemExit(f"reference failed: {r.stderr[-2000:]}")

    env2 = dict(os.environ)
    env2.update(JAX_PLATFORMS="cpu", ROVACA_NATIVE_THREADS="2")
    bam_ours = bam_args_ours or ["-i", os.path.join(workdir, "sample.bam")]
    r = subprocess.run(
        [sys.executable, "-m", "rovaca_tpu.cli", "HaplotypeCaller",
         *bam_ours, "-r", os.path.join(workdir, "ref.fa"),
         "-o", os.path.join(workdir, "ours.vcf"), *ours_extra],
        env=env2, capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise SystemExit(f"ours failed: {r.stderr[-2000:]}")

    cp = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "golden_e2e.py"),
         "diff", workdir, *diff_extra],
        capture_output=True, text=True)
    print(cp.stdout.strip())
    return cp.stdout.strip().splitlines()[-1] == "RESULT: MATCH"


# --------------------------------------------------------------------- modes
def mode_multicontig(workdir, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    spec = [("chrA", 90_000), ("chrB", 60_000), ("chrC", 40_000)]
    contigs, per_contig = [], []
    for name, ln in spec:
        ref, reads, _truth = _gen_contig(rng, ln, name, f"{name}_")
        contigs.append((name, ref))
        per_contig.append((name, ln, reads))
    _write_fasta(os.path.join(workdir, "ref.fa"), contigs)
    _write_multi_bam(os.path.join(workdir, "sample.bam"), per_contig)
    return _run_both_and_diff(workdir, [], [])


def mode_multibam(workdir, seed):
    """Our 2-BAM k-way merge vs the reference on the pre-merged stream.

    The reference binary's tool framework only ever opens bam_path()[0]
    (rovaca_tool.hpp:165-166, with an explicit 'TODO: for multiple bam
    files, header need to be merged') even though its BamLoader implements
    the k-way merge — so a like-for-like 2-BAM comparison is impossible
    against the binary. Instead the gate proves the merge property: our
    run over {a.bam, b.bam} must equal the reference's run over ONE
    combined BAM whose read order is the merge order (tid, pos, reverse,
    source file), i.e. exactly what the loader's comparator
    (bam_loader.cpp:98-101) would produce."""
    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    ref, reads, _truth = _gen_contig(rng, 120_000, "chr20", "")
    _write_fasta(os.path.join(workdir, "ref.fa"), [("chr20", ref)])
    # split fragments (not mates!) across two BAMs: both mates of a pair
    # stay in one file, like per-lane BAMs would
    a, b = [], []
    for r in reads:
        (a if hash(r.name) % 2 == 0 else b).append(r)
    _write_multi_bam(os.path.join(workdir, "a.bam"),
                     [("chr20", 120_000, a)])
    _write_multi_bam(os.path.join(workdir, "b.bam"),
                     [("chr20", 120_000, b)])
    merged = sorted([(r, 0) for r in a] + [(r, 1) for r in b],
                    key=lambda t: (t[0].pos, t[0].is_reverse, t[1]))
    _write_multi_bam(os.path.join(workdir, "sample.bam"),
                     [("chr20", 120_000, [r for r, _ in merged])],
                     presorted=True)
    return _run_both_and_diff(
        workdir, [], [],
        bam_args_ref=["-I", os.path.join(workdir, "sample.bam")],
        bam_args_ours=["-i", os.path.join(workdir, "a.bam"),
                       "-i", os.path.join(workdir, "b.bam")])


def mode_dbsnp(workdir, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    ref, reads, truth = _gen_contig(rng, 120_000, "chr20", "")
    _write_fasta(os.path.join(workdir, "ref.fa"), [("chr20", ref)])
    _write_multi_bam(os.path.join(workdir, "sample.bam"),
                     [("chr20", 120_000, reads)])
    # dbSNP: IDs at ~60% of truth sites (matching alleles), plus decoys at
    # other positions and same-position different-allele entries
    lines = ["##fileformat=VCFv4.2",
             "##contig=<ID=chr20,length=120000>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    entries = []
    for i, ((pos, r_a, a_a), _zyg) in enumerate(truth):
        if rng.random() < 0.6:
            entries.append((pos + 1, f"rs{1000 + i}", r_a, a_a))
        if rng.random() < 0.3:
            alt2 = "ACGT"[(("ACGT".index(r_a[0]) + 2) % 4)]
            if alt2 != a_a:
                entries.append((pos + 1, f"rsX{i}", r_a[0], alt2))
    for k in range(40):  # decoys away from variants
        p = int(rng.integers(1000, 119000))
        entries.append((p, f"rsD{k}", ref[p - 1], "ACGT"[k % 4]))
    entries.sort()
    for pos1, rsid, r_a, a_a in entries:
        lines.append(f"chr20\t{pos1}\t{rsid}\t{r_a}\t{a_a}\t.\t.\t.")
    dbsnp_plain = os.path.join(workdir, "dbsnp.vcf")
    with open(dbsnp_plain, "w") as f:
        f.write("\n".join(lines) + "\n")
    # bgzip + tabix for both sides
    from rovaca_tpu.io import bgzf, tabix
    dbsnp_gz = dbsnp_plain + ".gz"
    with open(dbsnp_plain, "rb") as fin:
        w = bgzf.Writer(dbsnp_gz)
        w.write(fin.read())
        w.close()
    tabix.build_index(dbsnp_gz)
    return _run_both_and_diff(workdir, ["--dbsnp", dbsnp_gz],
                              ["-d", dbsnp_gz],
                              diff_extra=["--check-id"])


def mode_bed(workdir, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    ref, reads, truth = _gen_contig(rng, 150_000, "chr20", "")
    _write_fasta(os.path.join(workdir, "ref.fa"), [("chr20", ref)])
    _write_multi_bam(os.path.join(workdir, "sample.bam"),
                     [("chr20", 150_000, reads)])
    # WES-style targets: windows around a subset of truth sites + empty
    # stretches; some targets share a padded overlap
    bed = os.path.join(workdir, "targets.bed")
    ivals = [(5000, 5400)]     # an empty stretch with no variant
    for (pos, _r, _a), _zyg in truth[::2]:
        lo = max(0, pos - int(rng.integers(20, 120)))
        hi = min(150_000, pos + int(rng.integers(20, 120)))
        ivals.append((lo, hi))
    ivals.sort()               # the reference requires sorted intervals
    with open(bed, "w") as f:
        for lo, hi in ivals:
            f.write(f"chr20\t{lo}\t{hi}\n")
    return _run_both_and_diff(workdir, ["-L", bed, "-P", "50"],
                              ["-b", bed, "-P", "50"])


MODES = {"multicontig": mode_multicontig, "multibam": mode_multibam,
         "dbsnp": mode_dbsnp, "bed": mode_bed}


def main():
    which = sys.argv[1]
    workdir = sys.argv[2]
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 20260821
    names = list(MODES) if which == "all" else [which]
    results = {}
    for name in names:
        print(f"==== mode {name} ====", flush=True)
        results[name] = MODES[name](os.path.join(workdir, name), seed)
    print({k: ("MATCH" if v else "DIVERGENT") for k, v in results.items()})
    sys.exit(0 if all(results.values()) else 1)


if __name__ == "__main__":
    main()
