"""Pure-XLA PairHMM forward over PairBatch tensors.

A ``lax.scan`` over read rows, each step fully vectorized over (hap-column,
pair) with the in-row deletion recurrence solved by an associative scan
(first-order affine recurrence D[j] = md*M[j-1] + dd*D[j-1] composed in
log2(Lh) steps).

The plain reference for the Hopper kernel (cuda.py), the `xla` engine the
tests run, the float64 rescue on the CPU backend, and the scorer of the
virtual-device mesh dryrun. Model semantics: see golden.py / reference
src/haplotypecaller/pairhmm/rovaca/avx_512_float.cc:29-183.
"""

import functools

import jax
import jax.numpy as jnp

from ... import constants as C


def _affine_compose(left, right):
    """Compose affine maps f(x) = a*x + b: right after left."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def _forward_one(trans, rbase, rlen, hbase, hlen):
    """One (hap-tile x read-tile) group.

    trans: (Lr, 8, 128) float; rbase: (Lr, 128) i32; rlen: (1, 128) i32;
    hbase: (Lh, 8, 128) i32; hlen: (8, 1) i32. Returns (8, 128) raw sums in
    trans' dtype (float32, or float64 under enable_x64 for rescue).
    """
    Lr = trans.shape[0]
    Lh = hbase.shape[0]
    f32 = trans.dtype.type
    initial_constant = (C.INITIAL_CONSTANT_F64
                        if trans.dtype == jnp.float64
                        else C.INITIAL_CONSTANT_F32)

    init_d = f32(initial_constant) / jnp.maximum(hlen, 1).astype(f32)
    init_d = jnp.broadcast_to(init_d, (8, 128))

    col_idx = jax.lax.broadcasted_iota(jnp.int32, (Lh, 8, 1), 0)
    hvalid = col_idx < hlen[None]                       # (Lh, 8, 1)

    # carries are padded along columns: index 0 = virtual column -1
    M0 = jnp.zeros((Lh + 1, 8, 128), f32)
    I0 = jnp.zeros((Lh + 1, 8, 128), f32)
    D0 = jnp.broadcast_to(init_d, (Lh + 1, 8, 128))

    def row_step(carry, row):
        Mp, Ip, Dp = carry
        t, r, i = row
        p_mm, p_gapm, p_mi, p_ii, p_md, p_dd, p_distm, p_1distm = (
            t[k][None, None, :] for k in range(8))       # (1, 1, 128)
        match = (r[None, None, :] & hbase) != 0          # (Lh, 8, 128)
        prior = jnp.where(hvalid,
                          jnp.where(match, p_1distm, p_distm),
                          f32(0.0))

        Mnew = prior * (Mp[:-1] * p_mm + (Ip[:-1] + Dp[:-1]) * p_gapm)
        Inew = Mp[1:] * p_mi + Ip[1:] * p_ii

        # D[j] = md*M[j-1] + dd*D[j-1], D[-1] = 0 for every real row
        m_left = jnp.concatenate([jnp.zeros((1, 8, 128), f32), Mnew[:-1]], 0)
        a = jnp.broadcast_to(p_dd, (Lh, 8, 128))
        b = p_md * m_left
        _, Dnew = jax.lax.associative_scan(_affine_compose, (a, b), axis=0)

        # copy-through for lanes whose read ended (reference kernel's len mask)
        valid = (i < rlen[0])[None, None, :]             # (1, 1, 128)
        Mnew = jnp.where(valid, Mnew, Mp[1:])
        Inew = jnp.where(valid, Inew, Ip[1:])
        Dnew = jnp.where(valid, Dnew, Dp[1:])

        zrow = jnp.zeros((1, 8, 128), f32)
        return (jnp.concatenate([zrow, Mnew], 0),
                jnp.concatenate([zrow, Inew], 0),
                jnp.concatenate([zrow, Dnew], 0)), None

    rows = (trans, rbase, jnp.arange(Lr, dtype=jnp.int32))
    (Mf, If, _), _ = jax.lax.scan(row_step, (M0, I0, D0), rows)
    return jnp.sum(Mf[1:], axis=0) + jnp.sum(If[1:], axis=0)


@functools.partial(jax.jit, static_argnames=())
def pairhmm_xla(trans, rbase, rlen, hbase, hlen):
    """Batched forward: (GH, GR, 8, 128) raw probabilities."""
    over_reads = jax.vmap(_forward_one, in_axes=(0, 0, 0, None, None))
    over_haps = jax.vmap(over_reads, in_axes=(None, None, None, 0, 0))
    return over_haps(trans, rbase, rlen, hbase, hlen)


@functools.partial(jax.jit, static_argnames=())
def pairhmm_xla_indexed(trans, rbase, rlen, hbase, hlen, hidx, ridx):
    """Indexed-pair ABI in pure XLA: tile stacks plus a (G,) pair list of
    (hap-tile, read-tile) indices; returns (G, 8, 128) raw probabilities.
    Gathers ride the device. An index of -1 reads the last tile (numpy
    wrap-around); the scheduler ignores those slots.
    """
    over_pairs = jax.vmap(_forward_one, in_axes=(0, 0, 0, 0, 0))
    return over_pairs(trans[ridx], rbase[ridx], rlen[ridx],
                      hbase[hidx], hlen[hidx])
