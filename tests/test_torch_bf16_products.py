"""The identity the bf16 backward's packed products rest on, in float64 on
the CPU.

The scalar bf16 mode rounds each product of two bf16 values as
``rnd<bf16>(__fmul_rn(a, b))``: the f32 product, then rounded to bf16.  The
packed route (``mul_rnd2`` in ``csrc/typed_mp_common.cuh``) multiplies two
pairs with one ``mul.rn.bf16x2``, which rounds the exact product once to
bf16.  The two agree because

1. the f32 product of two bf16 values (8 significant bits each) is their
   exact product wherever that lies in f32's normal range; it fails below
   it, where |a b| < 2^-126 and f32 keeps fewer bits (and above the
   largest finite f32, where both overflow to inf);
2. rounding the f32 product once to bf16 gives the rounding of the exact
   product everywhere, that range included.

The card test ``tests/test_torch_cuda.py::
test_bf16_packed_products_give_the_scalar_bits`` holds the two kernels to
the same bits on data with such products.
"""

import numpy as np

F32_MIN_NORMAL = 2.0 ** -126
F32_MAX = float(np.finfo(np.float32).max)


def _bf16_values(bits):
    """The finite bf16 values of 16-bit patterns, as float64."""
    v = (bits.astype(np.uint32) << 16).view(np.float32)
    return v[np.isfinite(v)].astype(np.float64)


def round_bf16(x):
    """float64 values rounded once to bf16, to nearest even: 8 significant
    bits down to 2^-126, a quantum of 2^-133 below it, inf from the
    largest finite plus half an ulp."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)
    q = np.exp2(np.maximum(e, -125) - 8.0)
    with np.errstate(invalid="ignore"):
        r = np.round(x / q) * q  # np.round rounds half to even
    r = np.where(np.isinf(x), x, r)
    return np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)


def _edge_pairs():
    """+-0, the largest finite, the least normal and subnormal bf16 values
    and products that leave f32's normal range in both directions."""
    vals = np.array([0.0, -0.0, 3.3895313892515355e38, -3.3895313892515355e38,
                     2.0 ** -126, 2.0 ** -133, -2.0 ** -130, 1.0, -1.5,
                     2.0 ** -70, 2.0 ** 70, 1.9921875 * 2.0 ** -64,
                     1.0078125 * 2.0 ** -63, 2.0 ** 127])
    a, b = np.meshgrid(vals, vals)
    return a.ravel(), b.ravel()


def _pairs(n=10 ** 6, seed=0):
    rng = np.random.default_rng(seed)
    a = _bf16_values(rng.integers(0, 1 << 16, size=n, dtype=np.uint16))
    b = _bf16_values(rng.integers(0, 1 << 16, size=n, dtype=np.uint16))
    m = min(len(a), len(b))
    ea, eb = _edge_pairs()
    return np.concatenate([a[:m], ea]), np.concatenate([b[:m], eb])


def test_round_bf16_is_torchs_rounding_of_f32():
    import torch

    rng = np.random.default_rng(1)
    with np.errstate(over="ignore"):
        x = (rng.standard_normal(10 ** 5)
             * np.exp2(rng.integers(-140, 128, 10 ** 5))).astype(np.float32)
    x = x[np.isfinite(x)]
    ref = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    assert np.array_equal(round_bf16(x.astype(np.float64)), ref)


def test_f32_product_of_bf16_values_is_exact_in_the_normal_range():
    a, b = _pairs()
    assert len(a) > 990_000
    exact = a * b  # float64: 16 significant bits, no underflow
    with np.errstate(over="ignore", under="ignore"):
        f32 = (a.astype(np.float32) * b.astype(np.float32)).astype(
            np.float64)
    normal = (np.abs(exact) >= F32_MIN_NORMAL) & (np.abs(exact) <= F32_MAX)
    assert np.array_equal(f32[normal], exact[normal])
    # where the identity fails: below f32's normal range (and overflow)
    below = (exact != 0) & (np.abs(exact) < F32_MIN_NORMAL)
    assert below.sum() > 10_000
    assert (f32[below] != exact[below]).any()
    assert np.isinf(f32[np.abs(exact) > F32_MAX]).all()


def test_rounding_the_f32_product_to_bf16_is_rounding_the_exact_product():
    a, b = _pairs()
    with np.errstate(over="ignore", under="ignore"):
        f32 = (a.astype(np.float32) * b.astype(np.float32)).astype(
            np.float64)
    got, want = round_bf16(f32), round_bf16(a * b)
    assert np.array_equal(np.signbit(got), np.signbit(want))
    assert np.array_equal(got, want)


def test_every_product_below_f32s_normal_range_rounds_alike():
    """Exhaustively where the first identity fails: every product of two
    8-bit significands P = p q (1 <= p, q <= 255, subnormal inputs
    included) at every scale 2^E that puts it below 2^-126, down to where
    both roundings give 0."""
    p = np.arange(1, 256, dtype=np.int64)
    prods = np.unique(np.outer(p, p))
    for E in range(-176, -126):
        exact = prods.astype(np.float64) * 2.0 ** E
        exact = exact[exact < F32_MIN_NORMAL]
        with np.errstate(under="ignore"):
            f32 = exact.astype(np.float32).astype(np.float64)
        assert np.array_equal(round_bf16(f32), round_bf16(exact)), E


# --------------------------------------------------------------------------
# the bf16 DIFF/NEIGHBOR backward's design (csrc/typed_mp_bwd.cu,
# ext_bwd_kernel): rnd2 and the single self-row product of max


def _cvt_rn_bf16x2(a, b):
    """``cvt.rn.bf16x2.f32 d, b, a`` (``__floats2bfloat162_rn(a, b)``) on
    float32 arrays, on their bits: each value rounded to nearest even in
    its upper 16 bits, a in the low half of the word and b in the high."""
    def rn(x):
        u = x.view(np.uint32).astype(np.uint64)
        r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
        return r.astype(np.uint32)
    return (rn(b) << 16) | rn(a)


def _unpack2(w):
    """``unpack2`` in csrc/typed_mp_common.cuh: the pair of f32 values a
    word of two bf16 holds, the low half first."""
    lo = (w << 16).astype(np.uint32).view(np.float32)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32)
    return lo, hi


def test_rnd2_rounds_each_product_as_the_scalar_rounding():
    """rnd2(x, y) of the two f32 products of a pair of d_etype terms, dm
    (bf16) times hg (an f32 sum of two bf16 rows), gives each product
    rounded to bf16 as rnd<bf16> (torch's rounding) gives it, in its own
    lane: normal, subnormal and zero products of both signs, and products
    near f32's largest finite value that stay finite."""
    rng = np.random.default_rng(7)
    n = 10 ** 6
    dm = _bf16_values(rng.integers(0, 1 << 16, size=n, dtype=np.uint16))
    rows = [_bf16_values(rng.integers(0, 1 << 16, size=n, dtype=np.uint16))
            for _ in range(2)]
    m = min(len(dm), *(len(r) for r in rows)) // 2 * 2
    with np.errstate(over="ignore", invalid="ignore"):
        hg = (rows[0][:m].astype(np.float32) + rows[1][:m].astype(np.float32))
        p = dm[:m].astype(np.float32) * hg
    p = p[np.isfinite(p)]
    p = p[: len(p) // 2 * 2]
    p = np.concatenate([p, np.float32([0.0, -0.0, 2.0 ** -140, -2.0 ** -133,
                                       3.3e38, -3.3e38])])
    x, y = p[0::2], p[1::2]
    lo, hi = _unpack2(_cvt_rn_bf16x2(x, y))
    import torch

    for got, ref in ((lo, x), (hi, y)):
        want = torch.from_numpy(ref).to(torch.bfloat16).float().numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _f32_sum(terms):
    acc = np.float32(0.0)
    for t in terms:
        acc = np.float32(acc + t)
    return acc


def test_max_self_row_skips_the_zero_products_bit_for_bit():
    """dh of a self row 2 d under max: the kept route sums, over d's K
    edges in ascending k from +0, the products rnd(dm_k w_k) with dm_k = g
    at the argmax and +0 elsewhere; the design forms the one product at the
    argmax and adds it to +0.  Bit for bit the same, the sign of a zero
    result included (+0 + -0 is +0), for products below f32's normal range
    and weights of either sign."""
    rng = np.random.default_rng(8)
    cases = 0
    for _ in range(20000):
        K = int(rng.integers(1, 10))
        w = (rng.standard_normal(K) * np.exp2(rng.integers(-140, 20, K)))
        w = round_bf16(w)
        g = round_bf16(rng.standard_normal()
                       * 2.0 ** float(rng.integers(-140, 20)))
        w[rng.random(K) < 0.1] *= 0.0  # zeros of either sign
        w = np.where(rng.random(K) < 0.05, -0.0, w)
        g = -0.0 if rng.random() < 0.05 else g
        am = int(rng.integers(0, K))
        dm = np.where(np.arange(K) == am, g, 0.0)
        full = _f32_sum(np.float32(round_bf16(d * x)) for d, x in zip(dm, w))
        one = np.float32(np.float32(0.0) + np.float32(round_bf16(g * w[am])))
        assert full.view(np.uint32) == one.view(np.uint32)
        cases += int(abs(g * w[am]) < 2.0 ** -126)
    assert cases > 1000
