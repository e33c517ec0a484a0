"""Interval-sharded divergence confinement.

A 2-shard run may only differ from the unsharded run at reservoir-
downsampled (>50-deep) pileups — the traversal-split Java-LCG stream picks
different survivors there, the same semantics the reference binary has
under -L splits. depth_masked_diff turns that documented excuse into a
verified invariant."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).parent
spec = importlib.util.spec_from_file_location(
    "race_e2e", HERE.parent / "scripts" / "race_e2e.py")
race = importlib.util.module_from_spec(spec)
spec.loader.exec_module(race)


@pytest.mark.slow
def test_two_shard_divergence_confined(tmp_path):
    d = str(tmp_path)
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", ROVACA_NATIVE_THREADS="1")
    gen = subprocess.run(
        [sys.executable, str(HERE.parent / "scripts" / "golden_e2e.py"),
         "gen", d, "60000", "30", "555111"],
        capture_output=True, text=True)
    assert gen.returncode == 0, gen.stderr[-500:]
    for name, extra in (("plain", []), ("shard", ["--shards", "2"])):
        cp = subprocess.run(
            [sys.executable, "-m", "rovaca_tpu.cli", "HaplotypeCaller",
             "-i", f"{d}/sample.bam", "-r", f"{d}/ref.fa",
             "-o", f"{d}/{name}.vcf", "--pairhmm-engine", "auto"] + extra,
            env=env, capture_output=True, text=True)
        assert cp.returncode == 0, cp.stderr[-800:]
    ok, detail = race.depth_masked_diff(f"{d}/plain.vcf", f"{d}/shard.vcf",
                                        bam_path=f"{d}/sample.bam")
    assert ok, detail
