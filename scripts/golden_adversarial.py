"""Adversarial golden corpora: sequence contexts that break naive callers.

Every earlier golden corpus drew its reference uniformly at random, which
under-represents exactly the contexts the reference's PCR model and
assembler were built for
(pairhmm_internal.cpp:65-119 STR detection; hc_assemble_* dangling ends).
This generator plants:

  - homopolymer runs >=10bp with het/hom STUTTER indels inside them
  - short-tandem-repeat expansions (2-6bp unit x 5-15 copies) with
    +/- one-unit indel variants
  - SNP clusters within 20bp of indels
  - reference N-gaps (50-300bp) with variants near their edges
  - a multi-contig layout (3 contigs, variants near contig edges)

and golden-gates VCF + GVCF against the reference binary via
scripts/golden_e2e.py's ref/ours/diff verbs.

Usage:
  python scripts/golden_adversarial.py gen  <dir> [seed]
  python scripts/golden_adversarial.py run  <dir>     # ref+ours+diff both modes
  python scripts/golden_adversarial.py all  <dir> [seed]
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

E2E = os.path.join(REPO, "scripts", "golden_e2e.py")

CONTIGS = ("chr20", "chr21", "chr22")
CONTIG_LEN = 150_000
COVERAGE = 30


def _plant_adversarial_ref(rng, length):
    """Reference with homopolymers, STRs, and N-gaps planted on a random
    backbone. Returns (ref_string, feature list [(kind, start, end, unit)])."""
    import simdata
    ref = list(simdata.random_ref(rng, length))
    feats = []
    cursor = 2000
    while cursor < length - 3000:
        kind = rng.choice(["homopoly", "str", "ngap", "plain"],
                          p=[0.3, 0.35, 0.1, 0.25])
        if kind == "homopoly":
            run = int(rng.integers(10, 25))
            base = rng.choice(list("ACGT"))
            ref[cursor:cursor + run] = base * run
            feats.append(("homopoly", cursor, cursor + run, base))
            cursor += run
        elif kind == "str":
            unit = "".join(rng.choice(list("ACGT"),
                                      size=int(rng.integers(2, 7))))
            reps = int(rng.integers(5, 16))
            s = unit * reps
            ref[cursor:cursor + len(s)] = s
            feats.append(("str", cursor, cursor + len(s), unit))
            cursor += len(s)
        elif kind == "ngap":
            run = int(rng.integers(50, 300))
            ref[cursor:cursor + run] = "N" * run
            feats.append(("ngap", cursor, cursor + run, "N"))
            cursor += run
        cursor += int(rng.integers(800, 2500))
    return "".join(ref[:length]), feats


def _truth_for(rng, ref, feats):
    """Truth variants targeting the planted features + SNP clusters near
    indels. Returns sorted [(pos, ref_allele, alt_allele, zyg)]."""
    truth = []
    used = []

    def clashes(pos, span=150):
        return any(abs(pos - u) < span for u in used)

    def addvar(pos, ra, aa, zyg):
        if ra == aa or "N" in ra or "N" in aa or not ra or not aa:
            return False
        if clashes(pos):
            return False
        truth.append((pos, ra, aa, zyg))
        used.append(pos)
        return True

    for kind, s, e, unit in feats:
        zyg = rng.choice(["het", "hom"])
        if kind == "homopoly" and rng.random() < 0.75:
            # stutter: +/-1 base inside the run (anchored at run start - 1)
            a = s - 1
            if rng.random() < 0.5:
                addvar(a, ref[a], ref[a] + unit, zyg)          # insertion
            else:
                addvar(a, ref[a:a + 2], ref[a], zyg)           # deletion
        elif kind == "str" and rng.random() < 0.75:
            a = s - 1
            if rng.random() < 0.5:
                addvar(a, ref[a], ref[a] + unit, zyg)          # +1 unit
            else:
                addvar(a, ref[a:a + len(unit) + 1], ref[a], zyg)  # -1 unit
        elif kind == "ngap" and rng.random() < 0.6:
            # SNP just outside the N-gap edge
            for edge in (s - int(rng.integers(3, 20)),
                         e + int(rng.integers(2, 20))):
                base = ref[edge]
                if base != "N":
                    alt = "ACGT"[("ACGT".index(base) + 1) % 4]
                    addvar(edge, base, alt, rng.choice(["het", "hom"]))
                    break

    # SNP clusters within 20bp of a fresh indel, in plain sequence
    for _ in range(len(ref) // 12_000):
        p = int(rng.integers(1500, len(ref) - 1500))
        if clashes(p, 250) or "N" in ref[p - 30:p + 30]:
            continue
        zyg = rng.choice(["het", "hom"])
        dlen = int(rng.integers(1, 5))
        if not addvar(p, ref[p:p + dlen + 1], ref[p], zyg):
            continue
        # cluster SNPs on the same haplotype within 20bp
        for off in (-int(rng.integers(5, 20)), int(rng.integers(dlen + 2,
                                                                20))):
            q = p + off
            base = ref[q]
            if base != "N":
                alt = "ACGT"[("ACGT".index(base) + 2) % 4]
                if not any(abs(q - u) < max(2, dlen + 1) for u in used):
                    truth.append((q, base, alt, zyg))
                    used.append(q)

    # near-contig-edge variants (first/last 600bp)
    for p in (int(rng.integers(150, 450)),
              int(len(ref) - rng.integers(150, 450))):
        base = ref[p]
        if base != "N" and not clashes(p):
            addvar(p, base, "ACGT"[("ACGT".index(base) + 3) % 4],
                   rng.choice(["het", "hom"]))

    # drop overlapping truth (sort + sweep)
    truth.sort()
    out = []
    prev_end = -10
    for pos, ra, aa, zyg in truth:
        if pos <= prev_end + 1:
            continue
        out.append((pos, ra, aa, zyg))
        prev_end = pos + len(ra)
    return out


def generate(outdir, seed=20260505):
    import simdata
    from rovaca_tpu.io.bai import build_index
    from rovaca_tpu.io.bam import BamHeader, BamWriter
    from rovaca_tpu.io.fasta import write_fasta

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    refs = {}
    all_reads = []
    truth_lines = []
    read_groups = ("rg1", "rg2")
    for ci, contig in enumerate(CONTIGS):
        ref, feats = _plant_adversarial_ref(rng, CONTIG_LEN)
        truth = _truth_for(rng, ref, feats)
        refs[contig] = ref
        hom = sorted((p, r, a) for p, r, a, z in truth if z == "hom")
        al = sorted((p, r, a) for p, r, a, z in truth)
        hap1 = simdata.apply_variants(ref, hom)
        hap2 = simdata.apply_variants(ref, al)
        n_frags = COVERAGE * CONTIG_LEN // (2 * 100) // 2
        for hap, pref in ((hap1, "h1_"), (hap2, "h2_")):
            reads = simdata.simulate_fragments(
                rng, ref, hap, contig, n_frags,
                name_prefix=f"{contig}_{pref}", read_groups=read_groups)
            # the reference's overlapping-pair qname cache compares names
            # with the assembly graph's fixed-width kmer equality
            # (hc_assemble_reads.c:146-157) — long shared name prefixes
            # (as real sequencers emit) collide it into an exit(-1).
            # Keep names early-diverging: unique fragment id FIRST.
            rename = {}
            for r in reads:
                if r.name not in rename:
                    rename[r.name] = f"f{len(rename)}c{ci}{pref}"
                r.name = rename[r.name]
            for r in reads:
                r.ref_id = ci
                # mate stays on the same contig
                if r.mate_ref_id == 0:
                    r.mate_ref_id = ci
            all_reads.extend(reads)
        for p, r, a, z in truth:
            truth_lines.append(f"{contig}\t{p + 1}\t{r}\t{a}\t{z}\n")

    fasta = os.path.join(outdir, "ref.fa")
    write_fasta(fasta, refs)
    rg = "".join(f"@RG\tID:{g}\tSM:NA12878\n" for g in read_groups)
    sq = "".join(f"@SQ\tSN:{c}\tLN:{CONTIG_LEN}\n" for c in CONTIGS)
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n" + sq + rg,
                       list(CONTIGS), [CONTIG_LEN] * len(CONTIGS))
    all_reads.sort(key=lambda r: (r.ref_id, r.pos))
    bam = os.path.join(outdir, "sample.bam")
    with BamWriter(bam, header) as w:
        for r in all_reads:
            r.tags.setdefault("RG", read_groups[0])
            w.write(r)
    build_index(bam)
    with open(os.path.join(outdir, "truth.txt"), "w") as f:
        f.writelines(truth_lines)
    print(f"adversarial corpus: {len(CONTIGS)} contigs x {CONTIG_LEN}bp, "
          f"{len(all_reads)} reads, {len(truth_lines)} truth variants "
          f"-> {outdir}")


def run_gates(outdir):
    ok = True
    for mode, flag in (("vcf", []), ("gvcf", ["--gvcf"])):
        for verb in ("ref", "ours"):
            subprocess.run([sys.executable, E2E, verb, outdir] + flag,
                           check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        p = subprocess.run([sys.executable, E2E, "diff", outdir] + flag,
                           capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        res = next((ln for ln in reversed(lines)
                    if ln.startswith("RESULT:")), "RESULT: ERROR")
        print(f"{mode}: {res}", flush=True)
        if "MATCH" not in res:
            ok = False
            for ln in lines[-12:]:
                print("   ", ln)
    print("ADVERSARIAL:", "ALL MATCH" if ok else "DIVERGENT")
    return ok


def main():
    verb = sys.argv[1]
    outdir = sys.argv[2]
    if verb in ("gen", "all"):
        seed = int(sys.argv[3]) if len(sys.argv) > 3 else 20260505
        generate(outdir, seed)
    if verb in ("run", "all"):
        sys.exit(0 if run_gates(outdir) else 1)


if __name__ == "__main__":
    main()
