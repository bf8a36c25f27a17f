"""Batched exact linear assignment (the Hungarian matcher's solver).

Counterpart of monodetr_tpu/models/matcher.py:lap_solve and
monodetr_tpu/ops/lap_pallas.py:lap_solve_pallas.  `lap_solve` runs the CUDA
kernel csrc/lap.cu:lap_kernel for a CUDA tensor (all problems in one
launch; each warp solves one problem from its cost matrix in shared
memory) and `lap_solve_plain` for a CPU tensor.  `lap_solve_plain` is the
plain PyTorch version: lap_solve transcribed op for op, batched over the
problems as jax.vmap batches it (a problem whose loop has ended keeps its
state while the others run on).  Both are bit-identical to lap_solve and
to scipy.optimize.linear_sum_assignment on the same f32 costs: every sum
is taken in lap_solve's order and there are no products.
"""

import numpy as np
import torch

from .. import _build

INF = 1e18  # lap_solve's "infinity"


def lap_solve_plain(cost, row_valid, iterations=None):
    """cost [..., N, N] f32, row_valid [..., N] bool -> col4row [..., N]
    int32: the column assigned to each valid row, -1 for skipped rows.
    `iterations`, an int64 tensor of one element per problem, is added each
    problem's count of Dijkstra iterations (rows scanned over all its
    augmenting paths): the length of the solver's sequential chain."""
    *lead, N, _ = cost.shape
    C = cost.reshape(-1, N, N).float()
    rv = row_valid.reshape(-1, N).bool()
    Pn = C.shape[0]
    dev = C.device
    ar = torch.arange(Pn, device=dev)
    cols = torch.arange(N, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)

    # greedy row-reduction init: u = row minimum, v = 0, each column taken
    # by the lowest valid row whose argmin it is
    u = torch.where(rv, C.min(2).values, torch.zeros((), device=dev))
    v = torch.zeros(Pn, N, device=dev)
    jmin = C.argmin(2)
    col4row = torch.full((Pn, N), -1, dtype=torch.long, device=dev)
    row4col = torch.full((Pn, N), -1, dtype=torch.long, device=dev)
    for i in range(N):
        j = jmin[:, i]
        take = rv[:, i] & (row4col[ar, j] < 0)
        row4col[ar[take], j[take]] = i
        col4row[ar[take], i] = j[take]

    n_work = torch.where(rv, cols, -1).max(1).values + 1
    for cur in range(int(n_work.max().item()) if Pn else 0):
        active = (cur < n_work) & rv[:, cur] & (col4row[:, cur] < 0)
        if not bool(active.any()):
            continue
        shortest = torch.full((Pn, N), INF, device=dev)
        path_row = torch.full((Pn, N), -1, dtype=torch.long, device=dev)
        SR = torch.zeros(Pn, N, dtype=torch.bool, device=dev)
        SC = torch.zeros(Pn, N, dtype=torch.bool, device=dev)
        i = torch.full((Pn,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros(Pn, device=dev)
        sink = torch.where(active, -1, 0)
        while True:
            go = sink < 0
            if not bool(go.any()):
                break
            if iterations is not None:
                iterations += go.reshape(iterations.shape)
            SR[ar[go], i[go]] = True
            cand = ((min_val[:, None] + C[ar, i]) - u[ar, i][:, None]) - v
            better = (cand < shortest) & ~SC & go[:, None]
            shortest = torch.where(better, cand, shortest)
            path_row = torch.where(better, i[:, None], path_row)
            masked = torch.where(SC, inf, shortest)
            j = masked.argmin(1)  # the lowest index on ties
            min_val = torch.where(go, masked[ar, j], min_val)
            SC[ar[go], j[go]] = True
            r = row4col[ar, j]
            sink = torch.where(go & (r < 0), j, sink)
            i = torch.where(go & (r >= 0), r, i)

        # dual updates, with the assignment from before the augmentation
        u[active, cur] = u[active, cur] + min_val[active]
        sh_c = shortest.gather(1, col4row.clamp(min=0))
        row_upd = SR & (cols != cur) & (col4row >= 0) & active[:, None]
        u = torch.where(row_upd, u + (min_val[:, None] - sh_c), u)
        v = torch.where(SC & active[:, None], v - (min_val[:, None] - shortest), v)

        # augment along the alternating path ending at sink
        j = sink
        done = ~active
        while not bool(done.all()):
            pi = path_row[ar, j.clamp(min=0)]
            todo = ~done
            row4col[ar[todo], j[todo]] = pi[todo]
            j_next = col4row[ar, pi.clamp(min=0)]
            col4row[ar[todo], pi[todo]] = j[todo]
            done = done | (pi == cur)
            j = torch.where(done, j, j_next)
    return col4row.to(torch.int32).reshape(*lead, N)


def lap_solve(cost, row_valid):
    """Exact LAP, batched: cost [..., N, N] f32, row_valid [..., N] bool ->
    col4row [..., N] int32 (-1 for skipped rows), N <= 64.  On CUDA the
    whole batch solves in one launch of the kernel."""
    if cost.device.type == "cpu":
        return lap_solve_plain(cost, row_valid)
    *lead, N, N2 = cost.shape
    if N != N2 or tuple(row_valid.shape) != (*lead, N):
        raise ValueError(f"lap_solve: cost {tuple(cost.shape)}, row_valid "
                         f"{tuple(row_valid.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"lap_solve: cost must be float32, not {cost.dtype}")
    c = cost.contiguous()
    rv = row_valid.to(torch.uint8).contiguous()
    _build.require_cuda("lap_solve", c, rv)
    out = torch.empty(*lead, N, dtype=torch.int32, device=cost.device)
    _build.launch("mdt_lap", c.data_ptr(), rv.data_ptr(), out.data_ptr(),
                  out.numel() // N if N else 0, N, _build.stream_of(c))
    lap_solve.launches += 1
    return out


lap_solve.launches = 0


def lap_step_latencies(iters=1024):
    """The latencies on the card of the links of one Dijkstra step of the
    kernel, from csrc/lap.cu:lap_probe_kernel (clock64 around dependent
    chains of `iters` repetitions on one warp): {"shared_load", "update",
    "argmin": SM cycles each, "clock_ghz": the SM clock during the probe}.
    A measurement, not a launch of the solver."""
    out = torch.zeros(6, dtype=torch.int64, device="cuda")
    _build.require_cuda("lap_step_latencies", out)
    _build.launch("mdt_lap_probe", out.data_ptr(), iters, _build.stream_of(out))
    c = out.tolist()
    return {"shared_load": c[0] / iters, "update": c[1] / iters, "argmin": c[2] / iters,
            "clock_ghz": c[3] / c[4]}


def lap_edge_cases(seed=11):
    """[(name, cost [P, N, N] f32, row_valid [P, N] bool)] as numpy: the
    solver's edge cases.  Row minima that are zeros of both signs (-0.0 and
    +0.0 tie under <, and the lowest column wins), exact ties (integer
    costs), validity scattered through the rows, no valid row, and N of 1,
    31, 32, 33 and 64 (a lane's second column, and problems whose costs
    start off 16-byte alignment)."""
    rng = np.random.RandomState(seed)

    def quantised(P, N, levels):
        return (rng.randint(0, levels, (P, N, N)) / 4.0).astype(np.float32)

    def scattered(P, N):
        return rng.rand(P, N) < rng.uniform(0.2, 0.9, (P, 1))

    cases = []
    zeros = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 1.0], np.float32), (16, 8, 8),
                       p=[0.1, 0.3, 0.3, 0.15, 0.15])
    cases.append(("signed zeros", zeros.astype(np.float32), scattered(16, 8) | (np.arange(8) < 4)))
    cases.append(("exact ties", quantised(16, 50, 8), np.ones((16, 50), bool)))
    cases.append(("scattered validity", quantised(16, 50, 40), scattered(16, 50)))
    cases.append(("no valid row", quantised(4, 50, 40), np.zeros((4, 50), bool)))
    for N in (1, 31, 32, 33, 64):
        P = 15  # odd: with N * N odd, every other problem starts off 16-byte alignment
        cost = np.where(rng.rand(P, 1, 1) < 0.5, quantised(P, N, 12),
                        rng.rand(P, N, N).astype(np.float32) * 10)
        cases.append((f"N={N}", cost.astype(np.float32), scattered(P, N)))
    return cases
