"""The port's plain Fp12 tower and Ate2 pairing check (K4's plain version)
against the JAX package and the host oracle.

(a) The plain tower (`ops/fp12`) against the JAX package's `ops/fp12` on two
seeded lanes, the JAX operations in one jit as `tests/test_pairing_kernel.py`
runs them: the Montgomery limbs are equal, row for row. Inverse and fixed
powers, which the JAX suite keeps out of tier-1, are held to the JAX
package's host oracle (`fabric_tpu.common.fp256bn`, pure Python). (b) The
port's `LineSchedule` arrays against the JAX package's (host numpy). (c)
The plain Miller values and final-exponentiated values against that
oracle's `miller_loop` / `fexp`, and (d) the unity verdicts of
`Ate2Kernel(w, device="cpu").check` against that oracle, on true, false,
None and identity lanes: the hold the JAX package's own tests put on its
K4 program (`test_pairing_kernel.py`), whose XLA:CPU run takes minutes and
is not repeated here. (e) The kernel's algebra, each step against the
plain one it replaces: the x-power chain with cyclotomic squares against
square and multiply, sparse line products against dense ones, f1 *
conj(f2) against f1 * inv(f2) under the final exponentiation, the
schedules' sparsity, the kernel's constants, and its operation counts
against a tally of the reference algorithms' operations. All comparisons
are exact.
"""

import random
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fabric_tpu.common import fp256bn as jhost
from fabric_tpu.ops import bignum as jbn
from fabric_tpu.ops import fp12 as jf12
from fabric_tpu.ops import pairing_kernel as jpk
from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import bignum as bn
from fabric_tpu_torch.ops import convert
from fabric_tpu_torch.ops import fp12 as f12
from fabric_tpu_torch.ops import pairing_kernel as pk
from torch_untraced import untraced  # noqa: F401

RNG_SEED = 20260731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand_fp12(rng):
    return tuple((rng.randrange(host.P), rng.randrange(host.P)) for _ in range(6))


# ---------------------------------------------------------------------------
# (a) the tower
# ---------------------------------------------------------------------------

TOWER_OPS = ["mul", "sqr", "frobenius-1", "frobenius-2", "conj"]


@pytest.fixture(scope="module")
def tower():
    rng = random.Random(RNG_SEED)
    xs = [_rand_fp12(rng) for _ in range(2)]
    ys = [_rand_fp12(rng) for _ in range(2)]
    x, y = f12.from_host(xs), f12.from_host(ys)
    port = {
        "mul": f12.mul(x, y), "sqr": f12.sqr(x), "frobenius-1": f12.frobenius(x, 1),
        "frobenius-2": f12.frobenius(x, 2), "conj": f12.conj(x),
    }
    with jbn.force_looped_cios():

        @jax.jit
        def fn(x_st, y_st):
            xx, yy = jf12.unpack(x_st), jf12.unpack(y_st)
            return (
                jf12.pack(jf12.fp12_mul(xx, yy)),
                jf12.pack(jf12.fp12_sqr(xx)),
                jf12.pack(jf12.fp12_frobenius(xx, 1)),
                jf12.pack(jf12.fp12_frobenius(xx, 2)),
                jf12.pack(jf12.fp12_conj(xx)),
            )

        outs = fn(x.numpy().astype(np.uint32), y.numpy().astype(np.uint32))
    jax_out = dict(zip(TOWER_OPS, (np.asarray(o) for o in outs)))
    want = {
        "mul": [jhost.fp12_mul(a, b) for a, b in zip(xs, ys)],
        "sqr": [jhost.fp12_sqr(a) for a in xs],
        "frobenius-1": [jhost.fp12_frobenius(a, 1) for a in xs],
        "frobenius-2": [jhost.fp12_frobenius(a, 2) for a in xs],
        "conj": [jhost.fp12_conj(a) for a in xs],
    }
    return xs, port, jax_out, want


@pytest.mark.parametrize("op", TOWER_OPS)
def test_tower_op_matches_jax(tower, op):
    _, port, jax_out, want = tower
    assert np.array_equal(port[op].numpy(), jax_out[op])
    assert f12.to_host(port[op]) == want[op]


def test_inverse_and_power_match_oracle(tower):
    xs = tower[0]
    x = f12.from_host(xs)
    assert f12.to_host(f12.inv(x)) == [jhost.fp12_inv(a) for a in xs]
    e = 0xDEADBEEF12345
    assert f12.to_host(f12.pow_const(x, e)) == [jhost.fp12_pow(a, e) for a in xs]
    one = f12.one(2, "cpu")
    assert f12.equal(f12.mul(x, f12.inv(x)), one).tolist() == [True, True]


# ---------------------------------------------------------------------------
# (b) the line schedules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def issuer():
    rng = random.Random(RNG_SEED + 1)
    gamma = rng.randrange(1, host.R)
    return gamma, host.g2_mul(host.G2_GEN, gamma), rng


@pytest.mark.parametrize("which", ["issuer", "generator"])
def test_line_schedule_matches_jax(issuer, which):
    q = issuer[1] if which == "issuer" else host.G2_GEN
    port, ref = pk.LineSchedule(q), jpk.LineSchedule(q)
    for name in ("dbl_a", "dbl_b", "add_a", "add_b", "has_add"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert len(port.corr) == len(ref.corr) == 2
    for (pa, pb), (ra, rb) in zip(port.corr, ref.corr):
        assert np.array_equal(pa, ra) and np.array_equal(pb, rb)
    assert len(port.has_add) == pk.STEPS == 65 and int(port.has_add.sum()) == pk.ADD_STEPS == 22


# ---------------------------------------------------------------------------
# (c) Miller values and (d) verdicts
# ---------------------------------------------------------------------------

LANES = ["true", "false", "none", "identity-abar", "identity-aprime", "true-generator"]


@pytest.fixture(scope="module")
def lanes(issuer):
    gamma, _, rng = issuer
    a = [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R)) for _ in range(3)]
    return {
        "true": (a[0], host.g1_mul(a[0], gamma)),
        "false": (a[1], host.g1_mul(a[1], (gamma + 1) % host.R)),
        "none": None,
        "identity-abar": (a[2], None),
        "identity-aprime": (None, host.g1_mul(a[2], gamma)),
        "true-generator": (host.G1_GEN, host.g1_mul(host.G1_GEN, gamma)),
    }


def _lane_points(pair):
    """The G1 points a lane runs with: (G1, G1) for a None pair or point."""
    if pair is None or pair[0] is None or pair[1] is None:
        return host.G1_GEN, host.G1_GEN
    return pair


@pytest.fixture(scope="module")
def miller(issuer, lanes):
    """The plain version's values for every lane, in one call."""
    return dict(zip(LANES, pk.miller2_values(issuer[1], [lanes[n] for n in LANES], device="cpu")))


@pytest.mark.parametrize("lane", LANES)
def test_miller_values_match_oracle(issuer, lanes, miller, lane):
    w = issuer[1]
    p1, p2 = _lane_points(lanes[lane])
    f1, f2, fe = miller[lane]
    assert f1 == jhost.miller_loop(w, p1)
    assert f2 == jhost.miller_loop(jhost.G2_GEN, p2)
    assert fe == jhost.fexp(jhost.fp12_mul(f1, jhost.fp12_inv(f2)))


@pytest.fixture(scope="module")
def verdicts(issuer, lanes):
    before = dict(pk.LAUNCHES)
    kernel = pk.Ate2Kernel(issuer[1], device="cpu")
    got = kernel.check([lanes[n] for n in LANES])
    assert pk.LAUNCHES == before
    return dict(zip(LANES, got))


def _oracle(w, pair) -> bool:
    if pair is None or pair[0] is None or pair[1] is None:
        return False
    t = jhost.fp12_mul(jhost.ate(w, pair[0]), jhost.fp12_inv(jhost.ate(jhost.G2_GEN, pair[1])))
    return jhost.gt_is_unity(jhost.fexp(t))


@pytest.mark.parametrize("lane", LANES)
def test_unity_verdict_matches_oracle(issuer, lanes, verdicts, lane):
    want = _oracle(issuer[1], lanes[lane])
    assert verdicts[lane] == want
    assert want == (lane in ("true", "true-generator"))


def test_debug_words_decode_to_host_values(tower):
    """The layout of the kernel's debug entry, (3, 12, 8, B) words with
    R = 2^256, decodes to the values it carries."""
    xs = tower[0]
    limbs = np.stack([f12.from_host(xs).numpy()] * 3)  # (3, 20, 12, B)
    words = convert.limbs_to_words(limbs, axis=1, modulus=host.P)  # (3, 8, 12, B)
    words = torch.from_numpy(np.moveaxis(words, 1, 2).view(np.int32).copy())
    assert pk.words_to_host(words) == [(x, x, x) for x in xs]


def test_kernel_for_issuer_is_cached_per_key_and_device(issuer):
    w_bytes = host.g2_to_bytes(issuer[1])
    k = pk.kernel_for_issuer(w_bytes, "cpu")
    assert pk.kernel_for_issuer(w_bytes, "cpu") is k
    assert k.check([]) == []
    assert np.array_equal(k.sched_w.dbl_a, pk.LineSchedule(issuer[1]).dbl_a)


# ---------------------------------------------------------------------------
# (e) the kernel's algebra
# ---------------------------------------------------------------------------


def _unitary(rng, n):
    """n seeded values after the final exponentiation's easy part (the JAX
    package's oracle): the cyclotomic subgroup, where the hard part runs."""
    out = []
    for _ in range(n):
        m = _rand_fp12(rng)
        s = jhost.fp12_mul(jhost.fp12_conj(m), jhost.fp12_inv(m))
        out.append(jhost.fp12_mul(jhost.fp12_frobenius(s, 2), s))
    return out


def test_cyclotomic_square_matches_square():
    xs = _unitary(random.Random(RNG_SEED + 2), 3)
    x = f12.from_host(xs)
    assert torch.equal(f12.cyc_sqr(x), f12.sqr(x))
    assert f12.to_host(f12.cyc_sqr(x)) == [jhost.fp12_sqr(v) for v in xs]


def test_final_exp_xchain_matches_square_and_multiply():
    """The x-power chain against the JAX package's oracle fexp (square and
    multiply over the hard part) and the port's plain final_exp_ref."""
    rng = random.Random(RNG_SEED + 3)
    vals = [_rand_fp12(rng), _rand_fp12(rng), jhost.FP12_ZERO]
    x = f12.from_host(vals)
    got = pk.final_exp_xchain_ref(x)
    assert f12.to_host(got) == [jhost.fexp(v) for v in vals]
    assert torch.equal(got, pk.final_exp_ref(x))


def test_conj_in_place_of_inverse_leaves_fexp_unchanged():
    """fexp(f1 * conj(f2)) == fexp(f1 * inv(f2)) of the JAX package's
    oracle, f2 = 0 included (m = 0)."""
    rng = random.Random(RNG_SEED + 4)
    v1 = [_rand_fp12(rng), _rand_fp12(rng), _rand_fp12(rng)]
    v2 = [_rand_fp12(rng), _rand_fp12(rng), jhost.FP12_ZERO]
    f1, f2 = f12.from_host(v1), f12.from_host(v2)
    got = pk.final_exp_ref(f12.mul(f1, f12.conj(f2)))
    want = [jhost.fexp(jhost.fp12_mul(a, jhost.fp12_inv(b))) if b != jhost.FP12_ZERO
            else jhost.FP12_ZERO for a, b in zip(v1, v2)]
    assert f12.to_host(got) == want
    assert torch.equal(got, pk.final_exp_ref(f12.mul(f1, f12.inv(f2))))


@pytest.mark.parametrize("which", ["issuer", "generator"])
def test_schedule_rows_are_sparse(issuer, which):
    rows = pk.schedule_rows(pk.LineSchedule(issuer[1] if which == "issuer" else host.G2_GEN))
    a, b = rows[0::2], rows[1::2]
    assert sorted(set(np.nonzero(a.any(axis=2))[1].tolist())) == list(pk.A_ROWS)
    assert sorted(set(np.nonzero(b.any(axis=2))[1].tolist())) == list(pk.B_ROWS)


def test_line_schedule_rejects_a_dense_row(monkeypatch):
    real = pk._line_coeffs

    def dense(t, q):
        a, b = real(t, q)
        return (a[0], (1, 2)) + a[2:], b  # w^1 nonzero

    monkeypatch.setattr(pk, "_line_coeffs", dense)
    with pytest.raises(ArithmeticError):
        pk.LineSchedule(host.G2_GEN)


@pytest.mark.parametrize("which", ["issuer", "generator"])
def test_sparse_line_product_matches_dense(issuer, lanes, which):
    """Every line of a schedule, at the lanes' G1 points: the kernel's
    sparse product f * l equals the dense one of the plain version."""
    q = issuer[1] if which == "issuer" else host.G2_GEN
    rows = torch.from_numpy(np.moveaxis(pk.schedule_rows(pk.LineSchedule(q)), 2, 0)
                            .astype(np.int64))  # (20, 4S + 4, 12)
    pts = [_lane_points(lanes[n])[0] for n in LANES[:2]]
    n_lines = rows.shape[1] // 2
    px = f12.const_rows([p[0] for p in pts for _ in range(n_lines)], 1, "cpu")[:, :, 0]
    py = f12.const_rows([p[1] for p in pts for _ in range(n_lines)], 1, "cpu")[:, :, 0]
    a = rows[:, 0::2].permute(0, 2, 1).repeat(1, 1, len(pts))  # (20, 12, L)
    b = rows[:, 1::2].permute(0, 2, 1).repeat(1, 1, len(pts))
    rng = random.Random(RNG_SEED + 5)
    f = f12.from_host([_rand_fp12(rng) for _ in range(a.shape[2])])
    assert torch.equal(pk.line_mul_ref(f, a, b, px, py), f12.mul(f, pk._line(a, b, px, py)))


CU = Path(pk.__file__).resolve().parent.parent / "csrc" / "bn256.cu"


def _cu_words(name: str) -> list:
    src = CU.read_text()
    body = src[src.index(f" {name}["):]
    body = body[body.index("{"):body.index("};")]
    return [int(w, 0) for w in re.findall(r"\b(0x[0-9A-Fa-f]+|0)u\b", body)]


def test_kernel_constants_match_fp256bn():
    """gamma_{n,k} for n = 1, 2, 3 (times R = 2^256) and |u| in bn256.cu."""
    words = _cu_words("GAMMA")
    vals = [sum(w << (32 * i) for i, w in enumerate(words[8 * n:8 * n + 8]))
            for n in range(len(words) // 8)]
    want = [(x << 256) % jhost.P for n in (1, 2, 3) for c in jhost._FROB_GAMMA[n] for x in c]
    assert vals == want
    u = re.search(r"U_ABS = 0x([0-9A-Fa-f]+)ull", CU.read_text()).group(1)
    assert int(u, 16) == abs(jhost.U) and abs(jhost.U).bit_length() - 1 == 62


def test_operation_counts_match_a_tally(monkeypatch):
    """MULS_PER_LANE and MULS_LEAST against the operations the reference
    algorithms call (the Miller loops of miller2_ref, a line each multiply
    by a line, and final_exp_xchain_ref), each at the cost of
    pairing_kernel.KERNEL and .LEAST; the kernel's costs the plain tower
    can witness are counted from its Montgomery multiplies (the kernel's
    whole lane is counted in tests/test_torch_bn256_emulated.py, the least
    costs by test_least_costs_are_met_by_a_counted_tower)."""
    calls = {}

    def counting(name, fn):
        def wrapped(*args, **kw):
            key = f"{name}{args[1]}" if name == "frobenius" else name
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kw)
        return wrapped

    rows_mm = [0]
    real_mm = bn.mont_mul

    def mm(ctx, a, b, nreduce=1):
        rows_mm[0] += torch.broadcast_shapes(a.shape, b.shape)[1]
        return real_mm(ctx, a, b, nreduce)

    x = f12.from_host(_unitary(random.Random(RNG_SEED + 6), 1))
    monkeypatch.setattr(bn, "mont_mul", mm)
    for name, fn, want in (("mul", lambda: f12.mul(x, x), pk.KERNEL.mul),
                           ("cyc_sqr", lambda: f12.cyc_sqr(x), pk.KERNEL.cyc_sqr),
                           ("line_mul", lambda: f12.line_mul(x, x[:, 0], x[:, 6:8], x[:, 10:12]),
                            pk.KERNEL.line)):
        rows_mm[0] = 0
        fn()
        assert rows_mm[0] == want, name
    monkeypatch.setattr(bn, "mont_mul", real_mm)

    for name in ("mul", "sqr", "cyc_sqr", "frobenius", "inv", "conj"):
        monkeypatch.setattr(f12, name, counting(name, getattr(f12, name)))
    monkeypatch.setattr(pk, "_line", counting("line", pk._line))
    w_tab, g_tab = pk._g2_tables(), pk._g2_tables()
    one = f12.const_rows([1], 1, "cpu")[:, :, 0]
    pk.miller2_ref(w_tab.limbs("cpu"), g_tab.limbs("cpu"), g_tab.sched.has_add, one, one, one, one)
    miller = dict(calls)
    calls.clear()
    pk.final_exp_xchain_ref(x)
    fexp = dict(calls)
    # the Miller loops: one pass for both; each line evaluated and multiplied
    # in (f12.sqr is a multiply in the plain tower)
    assert miller == {"sqr": pk.STEPS, "mul": pk.STEPS + miller["line"], "line": pk.LINES,
                      "conj": 1}
    # the final exponentiation: the easy part (an inverse, whose own two
    # multiplies the plain tower counts as such, two multiplies and a p^2
    # map), then the chain
    assert fexp == {"inv": 1, "mul": 2 + 2 + pk.CHAIN_MULS, "conj": fexp["conj"],
                    "frobenius1": 1, "frobenius2": 2, "frobenius3": 1, "cyc_sqr": 196}
    assert (pk.CHAIN_SQRS, pk.CHAIN_MULS) == (196, 77)

    def tally(c):
        loops = 2 * (miller["sqr"] * c.step + miller["line"] * c.line + c.corr)
        final = (fexp["inv"] * c.inv + (fexp["mul"] - 2 * fexp["inv"]) * c.mul
                 + fexp["cyc_sqr"] * c.cyc_sqr
                 + sum(fexp[f"frobenius{n}"] * c.frob[n - 1] for n in (1, 2, 3)))
        return 4 + loops + c.mul + final  # the radix change, f1 * conj(f2)

    assert tally(pk.KERNEL) == pk.MULS_PER_LANE == 30_774
    assert tally(pk.LEAST) == pk.MULS_LEAST == 20_836
    assert pk.MULS_PER_LANE_REPLACED == 123_514


class _Tower:
    """Fp2, Fp6 = Fp2[v]/(v^3 - xi) and Fp12 = Fp6[w]/(w^2 - v) on Python
    integers, at the least costs pairing_kernel.LEAST states, counting
    their multiplies mod p. An Fp12 value is the JAX oracle's six Fp2
    coefficients of w; its halves are (c0, c2, c4) and (c1, c3, c5)."""

    def __init__(self):
        self.muls = 0

    def m(self, a, b):
        self.muls += 1
        return a * b % jhost.P

    def add2(self, x, y):
        return ((x[0] + y[0]) % jhost.P, (x[1] + y[1]) % jhost.P)

    def sub2(self, x, y):
        return ((x[0] - y[0]) % jhost.P, (x[1] - y[1]) % jhost.P)

    def xi(self, x):
        return ((x[0] - x[1]) % jhost.P, (x[0] + x[1]) % jhost.P)

    def mul2(self, x, y):  # Karatsuba
        ac, bd = self.m(x[0], y[0]), self.m(x[1], y[1])
        s = self.m(x[0] + x[1], y[0] + y[1])
        return ((ac - bd) % jhost.P, (s - ac - bd) % jhost.P)

    def sqr2(self, x):
        return (self.m(x[0] + x[1], x[0] - x[1]), self.m(2 * x[0], x[1]))

    def inv2(self, x):  # the norm, a Fermat inverse, two products
        norm = (self.m(x[0], x[0]) + self.m(x[1], x[1])) % jhost.P
        self.muls += pk.MULS_FP_INV
        ni = pow(norm, jhost.P - 2, jhost.P)
        return (self.m(x[0], ni), self.m(-x[1], ni))

    def add6(self, a, b):
        return tuple(self.add2(x, y) for x, y in zip(a, b))

    def sub6(self, a, b):
        return tuple(self.sub2(x, y) for x, y in zip(a, b))

    def by_v(self, a):
        return (self.xi(a[2]), a[0], a[1])

    def mul6(self, a, b):  # Karatsuba: 6 Fp2 products
        v0, v1, v2 = self.mul2(a[0], b[0]), self.mul2(a[1], b[1]), self.mul2(a[2], b[2])
        t12 = self.sub2(self.sub2(self.mul2(self.add2(a[1], a[2]), self.add2(b[1], b[2])), v1), v2)
        t01 = self.sub2(self.sub2(self.mul2(self.add2(a[0], a[1]), self.add2(b[0], b[1])), v0), v1)
        t02 = self.sub2(self.sub2(self.mul2(self.add2(a[0], a[2]), self.add2(b[0], b[2])), v0), v2)
        return (self.add2(v0, self.xi(t12)), self.add2(t01, self.xi(v2)), self.add2(t02, v1))

    def mul6_by_12(self, a, b1, b2):  # a (b1 v + b2 v^2): 5 Fp2 products
        p11, p22 = self.mul2(a[1], b1), self.mul2(a[2], b2)
        mid = self.sub2(self.sub2(self.mul2(self.add2(a[1], a[2]), self.add2(b1, b2)), p11), p22)
        return (self.xi(mid), self.add2(self.mul2(a[0], b1), self.xi(p22)),
                self.add2(self.mul2(a[0], b2), p11))

    def sqr6(self, a):  # Chung-Hasan SQR2: 2 Fp2 products, 3 Fp2 squares
        s0, s4 = self.sqr2(a[0]), self.sqr2(a[2])
        ab = self.mul2(a[0], a[1])
        s1 = self.add2(ab, ab)
        s2 = self.sqr2(self.add2(self.sub2(a[0], a[1]), a[2]))
        bc = self.mul2(a[1], a[2])
        s3 = self.add2(bc, bc)
        return (self.add2(s0, self.xi(s3)), self.add2(s1, self.xi(s4)),
                self.sub2(self.sub2(self.add2(self.add2(s1, s2), s3), s0), s4))

    def inv6(self, a):  # as the oracle's _fp6_inv, its squares as squares
        c0 = self.sub2(self.sqr2(a[0]), self.xi(self.mul2(a[1], a[2])))
        c1 = self.sub2(self.xi(self.sqr2(a[2])), self.mul2(a[0], a[1]))
        c2 = self.sub2(self.sqr2(a[1]), self.mul2(a[0], a[2]))
        t = self.add2(self.xi(self.add2(self.mul2(a[2], c1), self.mul2(a[1], c2))),
                      self.mul2(a[0], c0))
        ti = self.inv2(t)
        return (self.mul2(c0, ti), self.mul2(c1, ti), self.mul2(c2, ti))

    @staticmethod
    def halves(x):
        return (x[0], x[2], x[4]), (x[1], x[3], x[5])

    @staticmethod
    def join(a0, a1):
        return (a0[0], a1[0], a0[1], a1[1], a0[2], a1[2])

    def mul12(self, x, y):  # Karatsuba: 3 Fp6 products
        (a0, a1), (b0, b1) = self.halves(x), self.halves(y)
        t0, t1 = self.mul6(a0, b0), self.mul6(a1, b1)
        t2 = self.mul6(self.add6(a0, a1), self.add6(b0, b1))
        return self.join(self.add6(t0, self.by_v(t1)), self.sub6(self.sub6(t2, t0), t1))

    def sqr12(self, x):  # complex squaring: 2 Fp6 products
        a0, a1 = self.halves(x)
        t = self.mul6(a0, a1)
        c0 = self.mul6(self.add6(a0, a1), self.add6(a0, self.by_v(a1)))
        c0 = self.sub6(self.sub6(c0, t), self.by_v(t))
        return self.join(c0, self.add6(t, t))

    def line(self, f, py, a3, b5, px):  # l = py + w (a3 v + (b5 px) v^2)
        l5 = (self.m(b5[0], px), self.m(b5[1], px))
        a0, a1 = self.halves(f)
        by_py = [tuple((self.m(c[0], py), self.m(c[1], py)) for c in h) for h in (a0, a1)]
        return self.join(self.add6(by_py[0], self.by_v(self.mul6_by_12(a1, a3, l5))),
                         self.add6(by_py[1], self.mul6_by_12(a0, a3, l5)))

    def frob(self, x, n):
        out = [x[0] if n % 2 == 0 else jhost.fp2_conj(x[0])]
        for k in range(1, 6):
            c = x[k] if n % 2 == 0 else jhost.fp2_conj(x[k])
            g = jhost._FROB_GAMMA[n][k]
            if g[1] == 0:
                out.append((self.m(c[0], g[0]), self.m(c[1], g[0])))
            elif g[0] == 0:
                out.append((self.m(-c[1], g[1]), self.m(c[0], g[1])))
            else:
                out.append(self.mul2(c, g))
        return tuple(out)

    def inv12(self, x):  # conj(x) / (a0^2 - v a1^2)
        a0, a1 = self.halves(x)
        ni = self.inv6(self.sub6(self.sqr6(a0), self.by_v(self.sqr6(a1))))
        return self.join(self.mul6(a0, ni), self.mul6(self.sub6(((0, 0),) * 3, a1), ni))


@pytest.mark.parametrize("op", ["mul", "sqr", "line", "frob1", "frob2", "frob3", "inv"])
def test_least_costs_are_met_by_a_counted_tower(op):
    """Each least cost of pairing_kernel.LEAST is met by an implementation
    whose values equal the JAX package's oracle."""
    rng = random.Random(RNG_SEED + 7)
    x, y = _rand_fp12(rng), _rand_fp12(rng)
    py, px = rng.randrange(jhost.P), rng.randrange(jhost.P)
    a3, b5 = [(rng.randrange(jhost.P), rng.randrange(jhost.P)) for _ in range(2)]
    t = _Tower()
    zero = jhost.FP2_ZERO
    dense = ((py, 0), zero, zero, a3, zero, jhost.fp2_mul(b5, (px, 0)))
    got, want, cost = {
        "mul": (lambda: t.mul12(x, y), jhost.fp12_mul(x, y), pk.LEAST.mul),
        "sqr": (lambda: t.sqr12(x), jhost.fp12_sqr(x), pk.LEAST.step),
        "line": (lambda: t.line(x, py, a3, b5, px), jhost.fp12_mul(x, dense), pk.LEAST.line),
        "frob1": (lambda: t.frob(x, 1), jhost.fp12_frobenius(x, 1), pk.LEAST.frob[0]),
        "frob2": (lambda: t.frob(x, 2), jhost.fp12_frobenius(x, 2), pk.LEAST.frob[1]),
        "frob3": (lambda: t.frob(x, 3), jhost.fp12_frobenius(x, 3), pk.LEAST.frob[2]),
        "inv": (lambda: t.inv12(x), jhost.fp12_inv(x), pk.LEAST.inv),
    }[op]
    assert got() == want
    assert t.muls == cost
    assert pk.LEAST.corr == 0 and pk.LEAST.cyc_sqr == pk.KERNEL.cyc_sqr
