"""The training ops of monodetr_torch against monodetr_tpu, in f32 on the CPU.

- box ops: equal within rtol 1e-6, atol 1e-6;
- lap_solve_plain bit-identical to matcher.lap_solve (random, tie-heavy,
  all-invalid, masked rectangular costs) and optimal as scipy's
  linear_sum_assignment is (equal total cost); on the solver's edge cases
  (ops/lap.py:lap_edge_cases: zeros of both signs, exact ties,
  scattered validity, no valid row, N of 1, 31, 32, 33 and 64) bit-identical
  to matcher.lap_solve and to lap_pallas.lap_solve_pallas in interpret
  mode; and a model of the CUDA kernel's parallel greedy start (every row's
  argmin at once, a column to the lowest valid row claiming it) equal to
  the sequential start of the kernel's first layout on the same problems;
- gradients of the kernels' plain versions against jax.grad of their JAX
  oracles: the encoder's (softmax -> clip -> windowed sampling,
  tests/test_msda_enc_fused.py:oracle) and the decoder's
  (ops/msda.py:ms_deform_attn_reference), with samples off the clamp
  boundary and >= 1/32 px off integer positions, where the bilinear
  derivative is one-sided and the two packages pick different sides
  (ROADMAP.md C3); rtol 1e-4, atol 1e-5;
- attention gradients at p = 0 against the XLA path of layers.py (below
  and above the fused-kernel threshold); rtol 1e-4, atol 1e-5;
- the plain dropout's statistics.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from monodetr_tpu.models.layers import MultiheadAttention as JaxMHA
from monodetr_tpu.models.matcher import lap_solve as jax_lap_solve
from monodetr_tpu.ops import box_ops as jax_box_ops
from monodetr_tpu.ops.lap_pallas import lap_solve_pallas
from monodetr_tpu.ops.msda import ms_deform_attn_reference
from monodetr_torch.models.layers import MultiheadAttention, dropout
from monodetr_torch.ops import box_ops
from monodetr_torch.ops.lap import lap_edge_cases, lap_solve, lap_solve_plain
from monodetr_torch.ops.msda import ms_deform_attn
from monodetr_torch.ops.msda_enc import ms_deform_attn_enc_fused
from tests.test_msda_enc_fused import SHAPES, oracle

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


def boxes(rng, *lead):
    xy = rng.rand(*lead, 2) * 0.8
    return np.concatenate([xy, xy + rng.rand(*lead, 2) * 0.3 + 0.01], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["box_cxcywh_to_xyxy", "box_cxcylrtb_to_xyxy",
                                  "box_xyxy_to_cxcywh", "box_area"])
def test_box_conversions_match_jax(name):
    rng = np.random.RandomState(0)
    x = rng.rand(3, 7, 6 if "lrtb" in name else 4).astype(np.float32)
    got = getattr(box_ops, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jax_box_ops, name)(x)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["box_iou_pairwise", "generalized_box_iou"])
def test_pairwise_iou_matches_jax(name):
    rng = np.random.RandomState(1)
    a, b = boxes(rng, 2, 9), boxes(rng, 2, 5)
    got = getattr(box_ops, name)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jax_box_ops, name)(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_elementwise_giou_matches_jax():
    rng = np.random.RandomState(2)
    a, b = boxes(rng, 4, 11), boxes(rng, 4, 11)
    got = box_ops.generalized_box_iou_elementwise(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_box_ops.generalized_box_iou_elementwise(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def lap_cases():
    rng = np.random.RandomState(3)
    N = 50
    random = rng.randn(12, N, N).astype(np.float32)
    ties = (np.round(rng.rand(12, N, N) * 8) / 4).astype(np.float32)
    n_valid = np.array([0, 1, 2, 5, 9, 17, 30, 49, 50, 3, 12, 40])
    prefix = np.arange(N)[None] < n_valid[:, None]
    scattered = rng.rand(12, N) < 0.3
    # masked rectangular: the real rows' costs, BIG_COST padding rows
    rect = np.where(prefix[..., None], random, 1e6).astype(np.float32)
    return {"random": (random, np.ones((12, N), bool)), "ties": (ties, scattered),
            "all_invalid": (random, np.zeros((12, N), bool)), "rect": (rect, prefix)}


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid", "rect"])
def test_lap_solve_plain_is_bit_identical_to_jax_and_optimal(case):
    cost, valid = lap_cases()[case]
    got = lap_solve_plain(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jax_lap_solve))(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lap_solve(torch.from_numpy(cost), torch.from_numpy(valid))
                                  .numpy(), got)  # the CPU wrapper is the plain version
    for p in range(len(cost)):
        rows = np.flatnonzero(valid[p])
        assert (got[p][~valid[p]] == -1).all()
        if len(rows) == 0:
            continue
        cols = got[p][rows]
        assert len(set(cols.tolist())) == len(rows) and (cols >= 0).all()
        r, c = linear_sum_assignment(cost[p][rows].astype(np.float64))
        np.testing.assert_allclose(cost[p][rows, cols].astype(np.float64).sum(),
                                   cost[p][rows][r, c].astype(np.float64).sum(),
                                   rtol=1e-6, atol=1e-5)


def test_enc_fused_plain_gradients_match_jax_oracle():
    rng = np.random.RandomState(5)
    S = sum(h * w for h, w in SHAPES)
    value = rng.randn(2, S, 8, 4).astype(np.float32)
    lim = 8 / 2 - 1 - 1e-2
    # odd multiples of 1/32, some beyond the window (clamped): the grid
    # centres are multiples of 1/16 at levels that halve
    off = (np.floor((rng.rand(2, S, 256) * 2 - 1) * (lim + 1) * 16) * 2 + 1) / 32
    off = off.astype(np.float32)
    logits = (rng.randn(2, S, 128) * 0.7).astype(np.float32)
    g = rng.randn(2, S, 8 * 4).astype(np.float32)

    want = jax.jit(jax.grad(lambda *x: jnp.vdot(g, oracle(*x).reshape(g.shape)),
                            argnums=(0, 1, 2)))(value, off, logits)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (value, off, logits)]
    (ms_deform_attn_enc_fused(xs[0], SHAPES, xs[1], xs[2], 8) * torch.from_numpy(g)).sum() \
        .backward()
    assert (np.abs(off) > lim).any() and (np.abs(off) < lim).any()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_sep_plain_gradients_match_jax_reference():
    rng = np.random.RandomState(6)
    S = sum(h * w for h, w in SHAPES)
    B, Q, H, L, P, D = 2, 30, 8, 4, 4, 4
    value = rng.randn(B, S, H, D).astype(np.float32)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)[:, None]  # [L, 1, 2]
    u = rng.rand(B, Q, H, L, P, 2)
    px = np.floor(u * (wh + 2) - 2) + 0.5 + (rng.rand(*u.shape) - 0.5) * 0.8
    loc = ((px + 0.5) / wh).astype(np.float32)
    att = rng.rand(B, Q, H, L, P).astype(np.float32)
    g = rng.randn(B, Q, H * D).astype(np.float32)

    want = jax.jit(jax.grad(lambda *x: jnp.vdot(g, ms_deform_attn_reference(
        x[0], SHAPES, x[1], x[2]).reshape(g.shape)), argnums=(0, 1, 2)))(value, loc, att)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (value, loc, att)]
    (ms_deform_attn(xs[0], SHAPES, xs[1], xs[2]) * torch.from_numpy(g)).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tq,tk", [(50, 40), (1100, 1000)])  # below / above 1e6 logits
def test_attention_gradients_match_xla_path(tq, tk):
    rng = np.random.RandomState(tq)
    C = 64
    q, k, v, g = (rng.randn(2, t, C).astype(np.float32) for t in (tq, tk, tk, tq))
    jm = JaxMHA(num_heads=8)
    params = jm.init(jax.random.PRNGKey(0), q, k, v)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32), params)

    def f(p, q, k, v):
        return jnp.vdot(g, jm.apply({"params": p}, q, k, v))

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(params, q, k, v)
    tm = MultiheadAttention(C, 8)
    with torch.no_grad():
        tm.in_proj_weight.copy_(torch.from_numpy(np.array(params["in_proj_kernel"]).T))
        tm.in_proj_bias.copy_(torch.from_numpy(np.array(params["in_proj_bias"])))
        tm.out_proj.weight.copy_(torch.from_numpy(np.array(params["out_proj"]["kernel"]).T))
        tm.out_proj.bias.copy_(torch.from_numpy(np.array(params["out_proj"]["bias"])))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (tm(*xs) * torch.from_numpy(g)).sum().backward()
    for x, w in zip(xs, want[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.in_proj_weight.grad.numpy(),
                               np.asarray(want[0]["in_proj_kernel"]).T, rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(tm.in_proj_bias.grad.numpy(), np.asarray(want[0]["in_proj_bias"]),
                               rtol=RTOL, atol=1e-4)


def test_plain_dropout_statistics():
    x = torch.ones(400, 1000)
    a = dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, dropout(x, 0.1, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, dropout(x, 0.1, torch.Generator().manual_seed(4)))
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005  # 400k draws: 5 standard deviations = 0.0024
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    assert abs(a.mean().item() - 1.0) < 0.006
    assert torch.equal(dropout(x, 0.1, None), x) and torch.equal(dropout(x, 0.0, None), x)
    # attention: the probabilities are dropped after their cast, then scaled
    m = MultiheadAttention(64, 8, dropout=0.5)
    with torch.no_grad():  # its in-projection is allocated, not initialised
        m.in_proj_weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    q = torch.randn(2, 30, 64, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(m(q, q, q, torch.Generator().manual_seed(0)), m(q, q, q))
    assert torch.equal(m(q, q, q, torch.Generator().manual_seed(0)),
                       m(q, q, q, torch.Generator().manual_seed(0)))


def test_lap_plain_counts_its_dijkstra_iterations():
    """`iterations` receives each problem's count of scanned rows over all
    its augmenting paths and leaves the assignment as it is: at least one
    per row the greedy start left unmatched, none for a problem it solved."""
    rng = np.random.RandomState(11)
    cost = torch.from_numpy(rng.rand(6, 9, 9).astype(np.float32))
    cost[0] = torch.eye(9) * -1 + 1  # the greedy start matches every row
    valid = torch.ones(6, 9, dtype=torch.bool)
    valid[5, 4:] = False
    steps = torch.zeros(6, dtype=torch.int64)
    got = lap_solve_plain(cost, valid, steps)
    assert torch.equal(got, lap_solve_plain(cost, valid))
    greedy_free = [len(set(range(9))) - len(set(cost[p].argmin(1).tolist())) for p in range(5)]
    assert steps[0] == 0 and all(int(steps[p]) >= greedy_free[p] for p in range(5))
    assert steps[1:5].min() > 0


EDGE_CASES = {name: (cost, valid) for name, cost, valid in lap_edge_cases()}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_lap_edge_cases_match_jax_and_pallas(case):
    """The kernel's edge cases: lap_solve_plain, matcher.lap_solve and the
    Pallas kernel (interpret mode) give the same assignment, bit for bit."""
    cost, valid = EDGE_CASES[case]
    got = lap_solve_plain(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jax_lap_solve))(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(lap_solve_pallas(jnp.asarray(cost), jnp.asarray(valid))), got)
    assert (got[~valid] == -1).all() and (got[valid] >= 0).all()


def greedy_sequential(cost, valid):
    """The first CUDA layout's greedy start: rows in ascending order, each
    valid row taking its argmin column if no earlier row took it."""
    col4row = np.full(valid.shape, -1)
    for p in range(len(cost)):
        taken = set()
        for i in range(cost.shape[1]):
            j = int(np.argmin(cost[p, i]))
            if valid[p, i] and j not in taken:
                taken.add(j)
                col4row[p, i] = j
    return col4row


def greedy_parallel(cost, valid):
    """csrc/lap.cu's greedy start: every row's argmin (the lowest column of
    the minimum, -0.0 == +0.0) at once, each column claimed by the lowest
    valid row whose argmin it is (the shared atomicMin), a row matched iff
    its claim won."""
    P, N, _ = cost.shape
    jmin = np.argmin(cost, 2)
    claim = np.full((P, N), N)
    for p in range(P):
        np.minimum.at(claim[p], jmin[p][valid[p]], np.flatnonzero(valid[p]))
    has = valid & (np.take_along_axis(claim, jmin, 1) == np.arange(N))
    return np.where(has, jmin, -1)


@pytest.mark.parametrize("case", list(EDGE_CASES) + ["ties", "rect"])
def test_parallel_greedy_start_equals_sequential(case):
    cost, valid = EDGE_CASES[case] if case in EDGE_CASES else lap_cases()[case]
    par = greedy_parallel(cost, valid)
    np.testing.assert_array_equal(par, greedy_sequential(cost, valid))
    if valid.any():  # what the solver keeps of the start: its rows stay matched
        assert ((lap_solve_plain(torch.from_numpy(cost), torch.from_numpy(valid)).numpy() >= 0)
                >= (par >= 0)).all()
