"""Cross-implementation PairHMM golden diff.

Feeds identical (haplotypes, reads) cases to the reference's AVX512 PairHMM
(via .refbuild/bin/pairhmm_harness, which drives rovaca::call_pairhmm exactly
like haplotypecaller_engine.cpp:238-250) and to our engines
(ops.pairhmm.compute_likelihoods), then compares the post-normalization
log10 likelihood matrices column-aligned by read name.

Case format (shared with the harness):
  `H R` line, H haplotype lines (first = ref), R SAM read lines.
Result format: surviving read names line, H matrix rows, blank line.

Usage:
  python scripts/golden_pairhmm.py gen  <dir>   # cases from tests/golden
  python scripts/golden_pairhmm.py ours <dir>   # -> result_ours.txt
  python scripts/golden_pairhmm.py diff <dir>
Reference side:
  .refbuild/bin/pairhmm_harness <dir>/cases.txt <dir>/result_ref.txt
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")
sys.path.insert(0, "scripts")

from golden_assembly import (REGION_PAD, parse_sam_line, read_cases,  # noqa
                             sam_line)
from rovaca_tpu.assembly import assembler  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent.parent / "tests" / "golden"


def gen_from_golden(outdir):
    import golden_assembly as ga
    d = pathlib.Path(outdir)
    d.mkdir(parents=True, exist_ok=True)
    ref = open(GOLDEN / "assembly_ref.txt").readline().rstrip("\n")
    cases = []
    with open(GOLDEN / "assembly_cases.txt") as fh:
        while True:
            head = fh.readline()
            if not head.strip():
                break
            c, beg, end, n = head.split("\t")
            reads = [parse_sam_line(fh.readline(), c) for _ in range(int(n))]
            fh.readline()
            cases.append((int(beg), int(end), reads))

    n_cases = 0
    with open(d / "cases.txt", "w") as out:
        for beg, end, reads in cases:
            ps, pe = (beg - 1) - REGION_PAD, (end - 1) + REGION_PAD
            fin = assembler.finalize_region_reads(reads, ps, pe)
            assembler.adjust_overlapping_pair_quals(fin)
            window = ref[ps:pe + 1].encode()
            haps = assembler.assemble_region(fin, window, ps)
            if len(haps) < 2 or len(haps) > 48 or not fin:
                continue
            # uniquify names post-adjust (mates share names otherwise)
            fin = [r.copy(name=f"{r.name}_{i}") for i, r in enumerate(fin)]
            out.write(f"{len(haps)} {len(fin)}\n")
            for h in haps:
                out.write(h.bases.decode() + "\n")
            for r in fin:
                out.write(sam_line(r, "chr1") + "\n")
            n_cases += 1
    print(f"wrote {n_cases} pairhmm cases to {outdir}")


def read_pairhmm_cases(outdir):
    cases = []
    with open(pathlib.Path(outdir) / "cases.txt") as fh:
        while True:
            head = fh.readline()
            if not head.strip():
                break
            h, r = map(int, head.split())
            haps = [fh.readline().rstrip("\n") for _ in range(h)]
            reads = [parse_sam_line(fh.readline()) for _ in range(r)]
            cases.append((haps, reads))
    return cases


def run_ours(outdir, engine="auto"):
    from rovaca_tpu.ops.pairhmm import api
    cases = read_pairhmm_cases(outdir)
    with open(pathlib.Path(outdir) / "result_ours.txt", "w") as out:
        for haps, reads in cases:
            lik, kept = api.compute_likelihoods(
                reads, [h.encode() for h in haps],
                pcr_model="CONSERVATIVE", engine=engine)
            out.write("\t".join(reads[i].name for i in kept) + "\n")
            for row in lik:
                out.write("\t".join(f"{v:.12e}" for v in row) + "\n")
            out.write("\n")
    print("wrote result_ours.txt")


def parse_matrix_result(path):
    blocks = []
    with open(path) as fh:
        lines = [line.rstrip("\n") for line in fh]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        names = lines[i].split("\t")
        rows = []
        i += 1
        while i < len(lines) and lines[i].strip():
            rows.append([float(x) for x in lines[i].split("\t")])
            i += 1
        blocks.append((names, np.array(rows)))
    return blocks


def diff(outdir, rtol=5e-5, atol=1e-4):
    d = pathlib.Path(outdir)
    ours = parse_matrix_result(d / "result_ours.txt")
    ref = parse_matrix_result(d / "result_ref.txt")
    assert len(ours) == len(ref), (len(ours), len(ref))
    n_ok = n_filter_diff = n_value_diff = 0
    worst = 0.0
    msgs = []
    for ci, ((rn, rm), (on, om)) in enumerate(zip(ref, ours)):
        # the reference's call_pairhmm pre-sizes its output to the original
        # read count; columns past the surviving reads are unwritten (NaN)
        # and ignored downstream — truncate to the emitted name count
        rm = rm[:, :len(rn)]
        om = om[:, :len(on)]
        if set(rn) != set(on):
            n_filter_diff += 1
            msgs.append(f"case {ci}: poorly-modelled filter differs: "
                        f"only_ref={set(rn) - set(on)} "
                        f"only_ours={set(on) - set(rn)}")
            continue
        perm = [on.index(x) for x in rn]
        om_aligned = om[:, perm]
        ad = np.abs(om_aligned - rm)
        rel = ad / np.maximum(np.abs(rm), 1e-30)
        bad = (ad > atol) & (rel > rtol)
        worst = max(worst, float(ad.max()))
        if bad.any():
            n_value_diff += 1
            k = int(bad.sum())
            msgs.append(f"case {ci}: {k} cells differ "
                        f"(max abs {ad.max():.3e}, max rel {rel.max():.3e})")
        else:
            n_ok += 1
    print(f"cases: {len(ref)}  ok: {n_ok}  filter-diff: {n_filter_diff}  "
          f"value-diff: {n_value_diff}  worst-abs: {worst:.3e}")
    for m in msgs[:30]:
        print(" ", m)
    return n_ok, n_filter_diff, n_value_diff


if __name__ == "__main__":
    cmd, outdir = sys.argv[1], sys.argv[2]
    if cmd == "gen":
        gen_from_golden(outdir)
    elif cmd == "ours":
        run_ours(outdir, engine=sys.argv[3] if len(sys.argv) > 3 else "auto")
    elif cmd == "diff":
        ok, fd, vd = diff(outdir)
        sys.exit(0 if (fd == 0 and vd == 0) else 1)
    else:
        raise SystemExit(f"unknown command {cmd}")
