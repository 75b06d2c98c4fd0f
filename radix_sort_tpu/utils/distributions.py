"""On-device input-distribution generators (the L4 layer).

The on-device equivalent of the reference's src/distr.rs: instead of host-side
``rand``/``rand_distr`` iterators, these are pure ``jax.random`` samplers
that generate benchmark data directly in device memory (no host->device transfer).

  key_uniform    -- uniform keys over the full dtype range, payload = 0
                    (distr.rs:40-52 KeyUniform)
  zipf           -- Zipf(s) over the full key range (distr.rs:54-76 ZipfU32,
                    distr.rs:108-130 ZipfU64); inverse-CDF of the continuous
                    bounded power law (the discrete rejection-inversion loop
                    of rand_distr is host-sequential and XLA-hostile; for
                    benchmark skew the continuous approximation is standard)
  geometric      -- Geometric(lambda) (distr.rs:4-38 MyExp)
  step_uniform   -- n equally spaced distinct values, duplicate-heavy
                    (distr.rs:78-106, 132-160 StepUniformU32/U64)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "key_uniform",
    "zipf",
    "geometric",
    "step_uniform",
    "make_pairs",
    "key_uniform_limbs",
    "zipf_limbs",
    "geometric_limbs",
    "step_uniform_limbs",
]

_UINT_DTYPES = (np.uint8, np.uint16, np.uint32, np.uint64)


def _uniform_bits(key, n: int, dtype) -> jnp.ndarray:
    dtype = np.dtype(dtype)
    if dtype == np.uint64:
        hi, lo = jax.random.split(key)
        h = jax.random.bits(hi, (n,), jnp.uint32).astype(jnp.uint64)
        l = jax.random.bits(lo, (n,), jnp.uint32).astype(jnp.uint64)
        return (h << np.uint64(32)) | l
    return jax.random.bits(key, (n,), dtype)


def key_uniform(key, n: int, dtype=jnp.uint32) -> jnp.ndarray:
    """Uniform keys over the full unsigned range (distr.rs:42-51)."""
    return _uniform_bits(key, n, dtype)


def zipf(key, n: int, dtype=jnp.uint32, s: float = 1.1) -> jnp.ndarray:
    """Zipf(s)-distributed keys over [1, dtype::MAX] (distr.rs:60-63, 114-117).

    Inverse-CDF sampling of the bounded continuous power law p(x) ~ x^-s on
    [1, M]: heavy mass on small keys, controlled by s -- the skew profile
    the splitter-sampled distributed shuffle is tested against.
    """
    dtype = np.dtype(dtype)
    m = float(np.iinfo(dtype).max)
    u = jax.random.uniform(key, (n,), jnp.float32, minval=1e-7, maxval=1.0)
    if abs(s - 1.0) < 1e-6:
        x = jnp.exp(u * np.log(m))
    else:
        t = 1.0 - s
        x = (1.0 + u * (m**t - 1.0)) ** (1.0 / t)
    x = jnp.clip(x, 1.0, m)
    # float -> int: values above 2**31 need a wide intermediate
    if dtype == np.uint64:
        return x.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32).astype(
            jnp.uint64
        )
    return jnp.minimum(x, m).astype(jnp.uint32).astype(dtype)


def geometric(key, n: int, lam: float = 0.01, dtype=jnp.uint32) -> jnp.ndarray:
    """Geometric(lambda): # failures before first success (distr.rs:17-19)."""
    u = jax.random.uniform(key, (n,), jnp.float32, minval=1e-37, maxval=1.0)
    g = jnp.floor(jnp.log(u) / np.log1p(-lam))
    m = float(np.iinfo(np.dtype(dtype)).max)
    return jnp.minimum(g, m).astype(dtype)


def step_uniform(key, n: int, num_steps: int, dtype=jnp.uint32) -> jnp.ndarray:
    """Uniform choice among ``num_steps`` equally spaced values
    s*(1+i), s = MAX/(num_steps+1) (distr.rs:83-92, 137-146): a duplicate-heavy
    distribution stressing bin-count skew."""
    dtype = np.dtype(dtype)
    step = np.iinfo(dtype).max // (num_steps + 1)
    i = jax.random.randint(key, (n,), 0, num_steps, jnp.uint32)
    if dtype == np.uint64:
        return (i.astype(jnp.uint64) + np.uint64(1)) * np.uint64(step)
    return ((i + np.uint32(1)) * np.uint32(step)).astype(dtype)


# ---------------------------------------------------------------------------
# Genuine 64-bit-domain samplers as (hi, lo) uint32 limb pairs.
#
# The reference's ZipfU64 samples Zipf<f32> over [1, u64::MAX]
# (distr.rs:108-130): f32 mantissa precision over the full 64-bit exponent
# range. These samplers reproduce that — the inverse-CDF value is decomposed
# as 2**y = mant24 * 2**(k-23) with y computed in f32, so they need neither
# f64 nor u64 arithmetic, and the skew shapes the FULL 64-bit value, not
# just the hi limb
# (a hi-shaped/lo-uniform fake has materially different duplicate structure).
# Bits below the 24-bit mantissa are filled with uniform jitter — sub-
# quantization-bin detail a full-precision sampler would produce.


def _pow2_to_limbs(y, jkey):
    """floor(2**y) for f32 y in [0, 64) -> (hi, lo) uint32 limbs, low bits
    below the 24-bit mantissa jittered uniformly."""
    k = jnp.clip(jnp.floor(y), 0.0, 63.0)
    f = jnp.clip(y - k, 0.0, 1.0)
    k = k.astype(jnp.int32)
    m24 = jnp.clip(
        jnp.floor(jnp.exp2(f) * (1 << 23)).astype(jnp.uint32),
        np.uint32(1 << 23),
        np.uint32((1 << 24) - 1),
    )
    sh = k - 23  # value = m24 * 2**sh
    shlo = jnp.clip(sh, 0, 31).astype(jnp.uint32)
    sh32 = jnp.clip(sh - 32, 0, 31).astype(jnp.uint32)
    shdn = jnp.clip(32 - sh, 0, 31).astype(jnp.uint32)
    shn = jnp.clip(-sh, 0, 31).astype(jnp.uint32)
    hi = jnp.where(sh >= 32, m24 << sh32, m24 >> shdn)
    lo = jnp.where(sh >= 32, np.uint32(0), m24 << shlo)
    hi = jnp.where(sh < 0, np.uint32(0), hi)
    lo = jnp.where(sh < 0, m24 >> shn, lo)
    # jitter the sh zero bits below the mantissa
    jh, jl = jax.random.split(jkey)
    rh = jax.random.bits(jh, y.shape, jnp.uint32)
    rl = jax.random.bits(jl, y.shape, jnp.uint32)
    mlo = jnp.where(
        sh >= 32, np.uint32(0xFFFFFFFF), (np.uint32(1) << shlo) - np.uint32(1)
    )
    mlo = jnp.where(sh <= 0, np.uint32(0), mlo)
    mhi = jnp.where(sh > 32, (np.uint32(1) << sh32) - np.uint32(1), np.uint32(0))
    return hi | (rh & mhi), lo | (rl & mlo)


def key_uniform_limbs(key, n: int):
    """Uniform u64 keys as (hi, lo) uint32 limbs (distr.rs:47-51)."""
    kh, kl = jax.random.split(key)
    return (
        jax.random.bits(kh, (n,), jnp.uint32),
        jax.random.bits(kl, (n,), jnp.uint32),
    )


def zipf_limbs(key, n: int, s: float = 1.1):
    """Zipf(s) over [1, 2**64) as (hi, lo) uint32 limbs (ZipfU64,
    distr.rs:108-130)."""
    ku, kj = jax.random.split(key)
    u = jax.random.uniform(ku, (n,), jnp.float32, minval=1e-7, maxval=1.0)
    if abs(s - 1.0) < 1e-6:
        y = u * 64.0
    else:
        t = 1.0 - s
        a = float(2.0 ** (64.0 * t))  # M**t in log2 space, f32-safe for |64t|<126
        y = jnp.log2(1.0 + u * (a - 1.0)) / t
    return _pow2_to_limbs(jnp.clip(y, 0.0, 63.999), kj)


def geometric_limbs(key, n: int, lam: float = 1e-12):
    """Geometric(lambda) as (hi, lo) uint32 limbs (MyExp over u64,
    distr.rs:27-31): floor(ln U / ln(1-lambda)), full 64-bit range for tiny
    lambda."""
    ku, kj = jax.random.split(key)
    u = jax.random.uniform(ku, (n,), jnp.float32, minval=1e-37, maxval=1.0)
    c = -np.log1p(-lam)  # host f64 constant
    y = jnp.log2(-jnp.log(u)) - np.float32(np.log2(c))
    hi, lo = _pow2_to_limbs(jnp.clip(y, 0.0, 63.999), kj)
    neg = y < 0.0  # values in [0, 1) floor to 0
    z = np.uint32(0)
    return jnp.where(neg, z, hi), jnp.where(neg, z, lo)


def _mul32x32(a, b_const: int):
    """Exact (a * b) for uint32 a and a 64-bit python constant b ->
    (hi, lo) uint32 limbs, via 16-bit partial products (no device u64)."""
    b_lo = np.uint64(b_const) & np.uint64(0xFFFFFFFF)
    b_hi = np.uint64(b_const) >> np.uint64(32)
    a = a.astype(jnp.uint32)
    al = a & np.uint32(0xFFFF)
    ah = a >> np.uint32(16)
    bl = np.uint32(int(b_lo) & 0xFFFF)
    bh = np.uint32((int(b_lo) >> 16) & 0xFFFF)
    # partial products of a * b_lo (each fits 32 bits)
    p0 = al * bl
    p1 = al * bh
    p2 = ah * bl
    p3 = ah * bh
    mid = (p0 >> np.uint32(16)) + (p1 & np.uint32(0xFFFF)) + (p2 & np.uint32(0xFFFF))
    lo = (p0 & np.uint32(0xFFFF)) | (mid << np.uint32(16))
    carry = mid >> np.uint32(16)
    hi = p3 + (p1 >> np.uint32(16)) + (p2 >> np.uint32(16)) + carry
    # + a * b_hi contributes only to hi (mod 2**64)
    hi = hi + a * np.uint32(int(b_hi) & 0xFFFFFFFF)
    return hi, lo


def step_uniform_limbs(key, n: int, num_steps: int):
    """num_steps equally spaced u64 values step*(1+i) as (hi, lo) uint32
    limbs — exact integers (StepUniformU64, distr.rs:132-160)."""
    step = (2**64 - 1) // (num_steps + 1)
    i = jax.random.randint(key, (n,), 0, num_steps, jnp.uint32)
    return _mul32x32(i + np.uint32(1), step)


def make_pairs(keys: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(key, payload=0) rows, mirroring the reference's tuple Distribution
    impls (e.g. distr.rs:47-51): payload is a zero word of the key width."""
    return keys, jnp.zeros_like(keys)
