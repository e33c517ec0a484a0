"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Sharding logic is validated on host devices exactly as the multi-device
dryrun does. Tests marked `gpu` need the card and skip elsewhere; run them
there with JAX_PLATFORMS=cuda python -m pytest tests -m gpu.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip the test unless JAX's default backend is a GPU. Decided when the
    test runs, so every worker collects the same tests."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs a GPU (JAX backend: {backend})")


class FakeRead:
    """Minimal read-like object for kernel-level tests."""

    def __init__(self, bases, quals, mapping_quality=60, ins_quals=None,
                 gcp=None, name="read"):
        self.bases = bases.encode() if isinstance(bases, str) else bytes(bases)
        self.quals = np.asarray(quals, dtype=np.uint8)
        self.mapping_quality = mapping_quality
        if ins_quals is not None:
            self.ins_quals = np.asarray(ins_quals, dtype=np.uint8)
        if gcp is not None:
            self.gcp = np.asarray(gcp, dtype=np.uint8)
        self.name = name

    def __len__(self):
        return len(self.bases)


@pytest.fixture
def rng():
    return np.random.default_rng(20260817)


def random_read(rng, length, max_qual=40, mapping_quality=60):
    bases = "".join(rng.choice(list("ACGT"), size=length))
    quals = rng.integers(2, max_qual, size=length)
    return FakeRead(bases, quals, mapping_quality)


def mutate(seq, rng, n_snp=0, n_ins=0, n_del=0):
    s = list(seq)
    for _ in range(n_snp):
        i = int(rng.integers(0, len(s)))
        s[i] = rng.choice([b for b in "ACGT" if b != s[i]])
    for _ in range(n_ins):
        i = int(rng.integers(0, len(s)))
        s.insert(i, str(rng.choice(list("ACGT"))))
    for _ in range(n_del):
        i = int(rng.integers(0, len(s) - 1))
        del s[i]
    return "".join(s)
