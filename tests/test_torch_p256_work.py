"""The multiply counts behind K1's and K2's bounds, each met by a counted
plain computation held to the JAX package's oracle.

`ops/p256_kernel.py` counts the least work known for a verify (Jacobian
formulas for a = -3, the widest fixed-base combs the card's L2 holds,
Montgomery's batch inversion, an addition chain for each inverse) and the
kernels' own (KERNEL_*, which `tests/test_torch_p256_emulated.py` holds
multiply by multiply to the g++ build of the `.cu`). Here every cost those
counts name is run on Python integers with a counting multiply, and the
result is held to `fabric_tpu.common.p256`: the kernels' complete formulas
(algorithms 4 and 6 of Renes-Costello-Batina 2016), the Jacobian doubling
and mixed addition, the two inverse chains, the batch inversion, the
check, u1 G + u2 Q through two combs at each width the bound takes, the
limb route's ladder at three widths, and the table kernel's comb. All
comparisons are exact.
"""

import random

import pytest

from fabric_tpu.common import p256 as jp
from fabric_tpu_torch.ops import p256_kernel as pk

P, N, B = jp.P, jp.N, jp.B


class Counter:
    """Multiplies mod m, counted."""

    def __init__(self, m):
        self.m = m
        self.n = 0

    def __call__(self, a, b):
        self.n += 1
        return a * b % self.m


def add4(f, p, q):
    """RCB algorithm 4, complete projective addition."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    t0, t1, t2 = f(x1, x2), f(y1, y2), f(z1, z2)
    t3 = (f(x1 + y1, x2 + y2) - t0 - t1) % P
    t4 = (f(y1 + z1, y2 + z2) - t1 - t2) % P
    y3 = (f(x1 + z1, x2 + z2) - t0 - t2) % P
    z3 = f(B, t2)
    x3 = 3 * (y3 - z3) % P
    z3, x3 = (t1 - x3) % P, (t1 + x3) % P
    y3 = 3 * (f(B, y3) - 3 * t2 - t0) % P
    t0 = (3 * t0 - 3 * t2) % P
    return ((f(t3, x3) - f(t4, y3)) % P, (f(x3, z3) + f(t0, y3)) % P,
            (f(t4, z3) + f(t3, t0)) % P)


def dbl6(f, p):
    """RCB algorithm 6, complete projective doubling."""
    x, y, z = p
    t0, t1, t2, xy, xz = f(x, x), f(y, y), f(z, z), f(x, y), f(x, z)
    y3 = 3 * (f(B, t2) - 2 * xz) % P
    x3, y3 = (t1 - y3) % P, (t1 + y3) % P
    t2 = 3 * t2 % P
    z3 = 3 * (f(B, 2 * xz) - t2 - t0) % P
    t0 = (3 * t0 - t2) % P
    yz2 = 2 * f(y, z) % P
    return ((f(x3, 2 * xy) - f(yz2, z3)) % P, (f(x3, y3) + f(t0, z3)) % P,
            4 * f(yz2, t1) % P)


def affine(pt):
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, P)
    return (x * zi % P, y * zi % P)


def proj(a):
    return (0, 1, 0) if a is None else (a[0], a[1], 1)


INF = (1, 1, 0)  # the Jacobian identity


def dbl_j(f, p):
    """dbl-2001-b, a = -3 (3M + 5S); the identity doubles to itself."""
    x, y, z = p
    if z == 0 or y == 0:
        return INF
    delta, gamma = f(z, z), f(y, y)
    beta = f(x, gamma)
    alpha = 3 * f(x - delta, x + delta) % P
    x3 = (f(alpha, alpha) - 8 * beta) % P
    z3 = (f(y + z, y + z) - gamma - delta) % P
    y3 = (f(alpha, 4 * beta - x3) - 8 * f(gamma, gamma)) % P
    return (x3, y3, z3)


def madd_j(f, p, q):
    """madd-2007-bl (7M + 4S): p Jacobian, q affine and not the identity.
    The exceptional cases are branched on: p the identity (a load), p = q
    (a doubling), p = -q (the identity)."""
    x1, y1, z1 = p
    if z1 == 0:
        return (q[0], q[1], 1)
    z1z1 = f(z1, z1)
    u2 = f(q[0], z1z1)
    s2 = f(f(q[1], z1), z1z1)
    h, r = (u2 - x1) % P, 2 * (s2 - y1) % P
    if h == 0:
        return dbl_j(f, p) if r == 0 else INF
    hh = f(h, h)
    i = 4 * hh % P
    j, v = f(h, i), f(x1, i)
    x3 = (f(r, r) - j - 2 * v) % P
    y3 = (f(r, v - x3) - 2 * f(y1, j)) % P
    z3 = (f(z1 + h, z1 + h) - z1z1 - hh) % P
    return (x3, y3, z3)


def affine_j(pt):
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, P)
    return (x * zi * zi % P, y * zi * zi * zi % P)


def _points(seed, k):
    rng = random.Random(seed)
    return [jp.scalar_mult(rng.randrange(1, N), jp.GENERATOR) for _ in range(k)]


@pytest.mark.parametrize("case", ["random", "identity-left", "identity-right", "equal",
                                  "opposite"])
def test_formulas_count_and_match_oracle(case):
    """The kernels' complete formulas on every case; the least count's
    Jacobian ones where they are not exceptional."""
    a, b = _points(1, 2)
    left, right = {"random": (a, b), "identity-left": (None, b), "identity-right": (a, None),
                   "equal": (a, a), "opposite": (a, (a[0], P - a[1]))}[case]
    want = jp.point_add(left, right)
    f = Counter(P)
    assert affine(add4(f, proj(left), proj(right))) == want and f.n == pk.MULS_ADD
    f = Counter(P)
    assert affine(dbl6(f, proj(left))) == jp.point_add(left, left)
    assert f.n == pk.MULS_DOUBLE
    if case == "random":
        # a Jacobian point with Z != 1, as the ladders hold it
        z = 0x1234567
        jac = (a[0] * z * z % P, a[1] * z * z * z % P, z)
        f = Counter(P)
        assert affine_j(madd_j(f, jac, b)) == want and f.n == pk.MULS_MIXED_ADD_JACOBIAN
        f = Counter(P)
        assert affine_j(dbl_j(f, jac)) == jp.point_add(a, a)
        assert f.n == pk.MULS_DOUBLE_JACOBIAN
    elif right is not None:  # the branches give the oracle's answer too
        assert affine_j(madd_j(Counter(P), (*left, 1) if left else INF, right)) == want


def _run_inv_chain(f, x):
    slots = [x] + [0] * 11
    x2 = f(x, x)
    for i in range(1, 8):
        slots[i] = f(slots[i - 1], x2)
    t = slots[1]
    for sq, mul, store in pk.INV_CHAIN:
        for _ in range(sq):
            t = f(t, t)
        t = f(t, slots[mul])
        if store >= 0:
            slots[store] = t
    return t


def _run_inv_p(f, x):
    def run(t, sq, m):
        for _ in range(sq):
            t = f(t, t)
        return f(t, m)
    x2 = run(x, 1, x)
    x3 = run(x2, 1, x)
    x6 = run(x3, 3, x3)
    x12 = run(x6, 6, x6)
    x15 = run(x12, 3, x3)
    x30 = run(x15, 15, x15)
    x32 = run(x30, 2, x2)
    t = run(x32, 32, x)  # ffffffff 00000001
    t = run(t, 128, x32)  # then three zero words and ffffffff
    t = run(t, 32, x32)
    t = run(t, 30, x30)
    return run(t, 2, x)  # fffffffd


def test_inverse_chains_count_and_invert():
    rng = random.Random(2)
    for _ in range(3):
        x = rng.randrange(1, N)
        f = Counter(N)
        assert _run_inv_chain(f, x) == pow(x, N - 2, N) and f.n == pk.MULS_INV_N
        y = rng.randrange(1, P)
        f = Counter(P)
        assert _run_inv_p(f, y) == pow(y, P - 2, P) and f.n == pk.MULS_INV_P


def _batch_invert(f, xs, invert):
    """Montgomery's trick: m inverses for 3 (m - 1) multiplies and one
    inverse."""
    prefix = [xs[0]]
    for x in xs[1:]:
        prefix.append(f(prefix[-1], x))
    inv = invert(prefix[-1])
    out = [0] * len(xs)
    for i in range(len(xs) - 1, 0, -1):
        out[i] = f(inv, prefix[i - 1])
        inv = f(inv, xs[i])
    out[0] = inv
    return out


def test_batch_inversion_costs_three_a_lane():
    xs = [random.Random(3).randrange(1, N) for _ in range(16)]
    f = Counter(N)
    assert _batch_invert(f, xs, lambda x: pow(x, N - 2, N)) == [pow(x, -1, N) for x in xs]
    assert f.n == 3 * (len(xs) - 1) <= (pk.LEAST_LANE_MOD_N - 3) * len(xs)


def test_check_in_montgomery_form_counts():
    """MULS_CHECK_LEAST: with X and Z in Montgomery form (R = 2^256), Z^2,
    r times Z^2 (plain r: the product is r Z^2 plain) and X out of the
    form decide x(R) mod n == r."""
    r_inv = pow(1 << 256, -1, P)
    calls = [0]

    def mont(a, b):
        calls[0] += 1
        return a * b * r_inv % P

    rng = random.Random(8)
    pt = jp.scalar_mult(rng.randrange(1, N), jp.GENERATOR)
    z = rng.randrange(1, P)
    x_m, z_m = pt[0] * z * z % P * (1 << 256) % P, z * (1 << 256) % P
    for r, want in ((pt[0] % N, True), ((pt[0] + 1) % N, False)):
        calls[0] = 0
        z2_m = mont(z_m, z_m)
        assert (mont(r, z2_m) == mont(x_m, 1)) == want
        assert calls[0] == pk.MULS_CHECK_LEAST


@pytest.mark.parametrize("tables", [1, 4, 9, 33])
def test_comb_bits_is_the_widest_that_fits(tables):
    """G alone (K1), G and the block's 3 keys, the headline's 8, the
    bucket's 32."""
    def size(w):
        return tables * pk.comb_windows(w) * ((1 << w) - 1) * pk.COMB_ENTRY_BYTES
    w = pk.comb_bits(tables)
    assert size(w) <= pk.L2_BYTES < size(w + 1)
    assert w == {1: 15, 4: 13, 9: 12, 33: 9}[tables]


def _comb_entry(point, bits, window, digit):
    return jp.scalar_mult(digit << (bits * window), point)


@pytest.mark.parametrize("keys", [3, 8, 32])
def test_two_comb_sum_counts_and_matches_oracle(keys):
    """least_lane_mod_p: u1 G + u2 Q from combs of the width the L2 holds
    for G and `keys` keys, a load and mixed additions (the entries a lane
    reads, from the oracle), then the check."""
    bits = pk.comb_bits(keys + 1)
    q = _points(4, 1)[0]
    rng = random.Random(5 + keys)
    u1, u2 = rng.randrange(1, N), rng.randrange(1, N)
    f = Counter(P)
    acc, reads = INF, 0
    for w in range(pk.comb_windows(bits)):
        for point, u in ((jp.GENERATOR, u1), (q, u2)):
            d = u >> (bits * w) & ((1 << bits) - 1)
            if d:
                acc = madd_j(f, acc, _comb_entry(point, bits, w, d))
                reads += 1
    want = jp.point_add(jp.scalar_mult(u1, jp.GENERATOR), jp.scalar_mult(u2, q))
    assert affine_j(acc) == want
    assert f.n == (reads - 1) * pk.MULS_MIXED_ADD_JACOBIAN
    assert pk.least_lane_mod_p(keys) == ((2 * pk.comb_windows(bits) - 1)
                                         * pk.MULS_MIXED_ADD_JACOBIAN + pk.MULS_CHECK_LEAST)


@pytest.mark.parametrize("bits", [3, 4, 5])
def test_limb_route_ladder_counts_and_matches_oracle(bits):
    """ladder_mod_p: Q's multiples in Jacobian form, made affine by one
    batch inversion (its inverse is the launch's), a Horner ladder over
    them whose first window is a load; then u1's windows from G's widest
    comb by mixed additions, as LEAST_LIMB_LANE_MOD_P adds them."""
    q = _points(6, 1)[0]
    rng = random.Random(7)
    # u2's top bit set: its top window is not zero at any width
    u1, u2 = rng.randrange(1, N), rng.randrange(1 << 255, N)
    f = Counter(P)
    jac = {1: (q[0], q[1], 1)}
    for d in range(2, 1 << bits):
        jac[d] = dbl_j(f, jac[d // 2]) if d % 2 == 0 else madd_j(f, jac[d - 1], q)
    ds = list(range(2, 1 << bits))
    zinv = _batch_invert(f, [jac[d][2] for d in ds], lambda z: pow(z, -1, P))
    table = {1: q}
    for d, zi in zip(ds, zinv):
        zi2 = f(zi, zi)
        table[d] = (f(jac[d][0], zi2), f(jac[d][1], f(zi2, zi)))
    assert all(table[d] == jp.scalar_mult(d, q) for d in table)
    windows = pk.comb_windows(bits)
    mask = (1 << bits) - 1
    top = u2 >> (bits * (windows - 1))
    acc = (table[top][0], table[top][1], 1) if top else INF
    for w in range(windows - 2, -1, -1):
        for _ in range(bits):
            acc = dbl_j(f, acc)
        d = u2 >> (bits * w) & mask
        if d:
            acc = madd_j(f, acc, table[d])
    ladder = f.n
    g_bits = pk.comb_bits(1)
    for w in range(pk.comb_windows(g_bits)):
        d = u1 >> (g_bits * w) & ((1 << g_bits) - 1)
        if d:
            acc = madd_j(f, acc, _comb_entry(jp.GENERATOR, g_bits, w, d))
    want = jp.point_add(jp.scalar_mult(u1, jp.GENERATOR), jp.scalar_mult(u2, q))
    assert affine_j(acc) == want
    # the batch inversion takes 3 (m - 1) for m entries: a launch's entries
    # in the count (3 a lane's entry), one lane's here
    zero_windows = sum((u2 >> (bits * w) & mask) == 0 for w in range(windows - 1))
    assert ladder == pk.ladder_mod_p(bits) - 3 - zero_windows * pk.MULS_MIXED_ADD_JACOBIAN
    assert f.n - ladder == pk.comb_windows(g_bits) * pk.MULS_MIXED_ADD_JACOBIAN
    assert pk.LADDER_BITS == 4 and pk.LEAST_LIMB_LANE_MOD_P == (
        2 + pk.ladder_mod_p(4) + (f.n - ladder) + pk.MULS_CHECK_LEAST)


def test_projective_comb_counts_and_matches_oracle():
    """LEAST_TABLE_MOD_P: the table kernel's 4-bit projective comb with the
    complete formulas, the windows' bases by 63 doublings of digit 8, digits
    2..15 a window by 7 doublings and 7 additions."""
    q = _points(9, 1)[0]
    f = Counter(P)
    rows = []
    for w in range(pk.NUM_WINDOWS):
        row = {1: dbl6(f, rows[-1][8]) if w else proj(q)}
        for d in range(2, 16):
            row[d] = dbl6(f, row[d // 2]) if d % 2 == 0 else add4(f, row[d - 1], row[1])
        rows.append(row)
    assert f.n == pk.LEAST_TABLE_MOD_P
    for w, d in ((0, 15), (1, 2), (31, 7), (63, 15)):
        assert affine(rows[w][d]) == jp.scalar_mult(d << (4 * w), q)
