"""
The host side of K10's and K11's cluster route on the CPU: the cluster
plan (``fused.lml_cluster``, ``fused.lbfgs_lml_fit_cluster``,
``fused.lml_value_grad_cluster``, the mirrors of csrc/lml_blocked.cuh
lml_cluster, csrc/lbfgs_lml_fit.cu gpry_lbfgs_lml_fit_cluster and
csrc/lml_value_grad.cu gpry_lml_value_grad_cluster; the card test
``test_lbfgs_plans_match_the_kernels`` holds each to its C side), the route
edges it leaves as they were, and the deal of the work over a cluster's
blocks (``update_deal``, ``column_deal`` below, the rules of
csrc/lml_blocked.cuh lml_syrk, lml_trtri and lml_lauum): every tile of a
trailing update and of a chunk of L^-1's or K^-1's row panel once.
"""

import copy
from fractions import Fraction

import pytest

from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops.kernels import build_kernel_spec

from test_torch_lbfgs_reuse import ALL_NODES

# an H100 SXM's SMs, and the blocks of K10's route 1 an SM holds there
SMS, PER_SM = 132, 2
# clusters of C blocks the card runs at once: as many as the SMs hold
# (ROOMY); an H100's for K11's route 1 (its SMs come in groups that 16
# does not divide: 7 clusters of 16, 15 of 8); a card that holds far fewer
# clusters of 16 (SCARCE), and one that holds none (NONE16)
ROOMY = {c: SMS // c for c in (1, 2, 4, 8, 16)}
H100 = {1: SMS, 2: 66, 4: 30, 8: 15, 16: 7}
ACTIVE = {"roomy": ROOMY, "h100": H100,
          "scarce": {1: SMS, 2: 66, 4: 30, 8: 15, 16: 2},
          "none16": {1: SMS, 2: 66, 4: 30, 8: 15, 16: 0}}
# route 1's trailing update: a chunk's rows on one block (LML_SYRK_H; half
# of it on a cluster), and the warps of a block (LML_WARPS)
SYRK_H, WARPS = 128, 8


def update_deal(n, b0, C):
    """
    Route 1's deal of one trailing update (csrc/lml_blocked.cuh lml_syrk)
    on rows and columns ``b0..n`` (the border row n included) over a
    cluster of ``C`` blocks: ``{rank: [(r0, c0), ...]}``, the 16 x 16 blocks
    (first row, first column) that each block updates, in its order.
    Chunks of ``H`` rows (128 on one block, 64 on a cluster), chunk pair q
    (numbered by rows, columns up to the diagonal) on block q mod C.
    """
    H = SYRK_H if C == 1 else SYRK_H // 2
    deal = {r: [] for r in range(C)}
    q = 0
    for R0 in range(b0, n + 1, H):
        sr_n = (min(n + 1 - R0, H) + 15) // 16
        for C0 in range(b0, R0 + 1, H):
            sc_n = sr_n if C0 == R0 else H // 16
            deal[q % C] += [(R0 + 16 * sr, C0 + 16 * sc)
                            for sr in range(sr_n) for sc in range(sc_n)
                            if C0 != R0 or sc <= sr]
            q += 1
    return deal


def column_deal(C):
    """
    Route 1's deal of the 8-column tiles of one chunk of L^-1's or K^-1's
    row panel (``C * 256`` columns, csrc/lml_blocked.cuh lml_trtri,
    lml_lauum) over a cluster of ``C`` blocks: ``{(rank, warp): [tile,
    ...]}``.  Pairs of tiles go round the blocks first (pair q to block q
    mod C, warp q // C mod 8, then the next 8 C pairs), so that each block
    works across the whole panel; on one block warp w takes tiles 2 w,
    2 w + 1, 2 w + 16, 2 w + 17.
    """
    NW = C * WARPS
    return {(rank, warp): [2 * (NW * m + C * warp + rank) + h
                           for m in range(2) for h in range(2)]
            for rank in range(C) for warp in range(WARPS)}


def all_nodes(d):
    """(theta entries, shared doubles) of ALL_NODES's program at d."""
    tree = copy.deepcopy(ALL_NODES)
    tree["Sum"][0]["Product"][1]["Exponentiation"]["kernel"]["Matern"][
        "length_scale"] = [0.6] * d
    spec, theta0, _ = build_kernel_spec(tree, d)
    return len(theta0), 2 * len(fused.encode_spec(spec, d)[0]) \
        + 2 * len(theta0)


def last_route0(plan):
    """The last n that ``plan`` (n -> (route, ...)) keeps on route 0."""
    n = 1
    while plan(n + 1)[0] == 0:
        n += 1
    return n


@pytest.mark.parametrize("rows,C,card", [
    (1, 16, "roomy"), (2, 16, "roomy"), (8, 16, "roomy"), (9, 8, "roomy"),
    (16, 8, "roomy"), (26, 4, "roomy"), (33, 4, "roomy"), (44, 2, "roomy"),
    (66, 2, "roomy"), (67, 1, "roomy"), (132, 1, "roomy"),
    (2049, 1, "roomy"), (2, 16, "h100"), (7, 16, "h100"), (8, 16, "h100"),
    (16, 8, "h100"), (17, 4, "h100"), (33, 4, "h100"), (4, 16, "scarce"),
    (5, 8, "scarce"), (8, 8, "scarce"), (1, 8, "none16")])
def test_lml_cluster(rows, C, card):
    """Of the powers of two up to 16 with rows * C <= the SMs, the most
    blocks a lane per wave of resident clusters (C / ceil(rows /
    active[C])), the larger on a tie: on an H100 (7 clusters of 16
    resident) a full fit's 8 lanes take 16 blocks each in two waves, as
    fast a share as 8 blocks in one, and a simple fit's 2 take 16; where
    far fewer clusters of 16 fit, fewer blocks; never a size the card
    cannot schedule; a screen of 2,049 rows a block a row."""
    active = ACTIVE[card]
    assert fused.lml_cluster(rows, SMS, active) == C
    cands = [c for c in (1, 2, 4, 8, 16)
             if (c == 1 or rows * c <= SMS) and active[c] >= 1]
    rate = lambda c: Fraction(c, -(-rows // active[c]))
    assert C in cands and rate(C) == max(rate(c) for c in cands)
    assert all(rate(c) < rate(C) for c in cands if c > C)


@pytest.mark.parametrize("family,d", [("rbf", 8), ("spec", 8),
                                      ("rbf", 48)])
def test_route_edges_unchanged(family, d):
    """Route 0 ends where it did (K11 at n = 236, K10 at n = 237 for a fast
    family at d = 8; a spec program's K10 takes route 1 from n = 160), so
    route 0's paths keep their launches; route 1 reaches d = 48's default
    budget (23,278)."""
    p, sd = all_nodes(d) if family == "spec" else (d + 1, 0)
    k11 = lambda n: fused.lbfgs_lml_fit_plan(n, d, p, sd)
    k10 = lambda n: fused.lml_value_grad_plan(n, d, sd)
    if family == "rbf" and d == 8:
        assert last_route0(k11) == 236
        assert last_route0(k10) == 237
    if family == "spec":
        assert k10(159)[0] == 0 and k10(160)[0] == 1
    if d == 48:
        assert k11(int(70 * d ** 1.5))[0] == 1
        assert k10(int(70 * d ** 1.5))[0] == 1


@pytest.mark.parametrize("R", (1, 2, 8, 16, 26))
@pytest.mark.parametrize("n", (236, 237, 1024, 2048, 23278))
def test_lbfgs_lml_fit_cluster(R, n):
    """K11's cluster: one block a lane on route 0, lml_cluster(R) blocks on
    route 1; never more blocks than the SMs, and a size the card
    schedules."""
    d = 48 if n == 23278 else 8
    C = fused.lbfgs_lml_fit_cluster(R, n, d, d + 1, SMS, H100)
    route = fused.lbfgs_lml_fit_plan(n, d, d + 1)[0]
    assert C == (fused.lml_cluster(R, SMS, H100) if route == 1 else 1)
    assert route == int(n > 236) and R * C <= SMS and H100[C] >= 1


@pytest.mark.parametrize("R", (1, 2, 16, 2049, 2056))
@pytest.mark.parametrize("d,n", [(8, 224), (8, 237), (8, 1024), (8, 2048),
                                 (16, 4480), (48, 23278)])
def test_lml_value_grad_cluster(R, d, n):
    """K10's rows in flight F and cluster C: F the fewest of R, the blocks
    the SMs hold and the rows whose workspaces fit LML_WORK_BUDGET (at
    least 1), C = 1 on route 0 and lml_cluster(F) on route 1, so F C never
    exceeds the blocks the SMs hold and the workspaces the budget."""
    route, _, _, work = fused.lml_value_grad_plan(n, d)
    per_sm = PER_SM if route == 1 else 1
    F, C = fused.lml_value_grad_cluster(R, n, d, SMS, per_sm, H100)
    assert F == max(1, min(R, per_sm * SMS,
                           fused.LML_WORK_BUDGET // (8 * work)))
    assert C == (fused.lml_cluster(F, SMS, H100) if route == 1 else 1)
    assert F * C <= per_sm * SMS and H100[C] >= 1
    assert F == 1 or F * 8 * work <= fused.LML_WORK_BUDGET
    if (R, n) == (2049, 4480):
        assert (F, C) == (212, 1)
    if (R, n) == (2, 23278):
        assert (F, C) == (2, 16)


@pytest.mark.parametrize("C", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("n,b0", [(237, 16), (300, 160), (1024, 16),
                                  (1024, 976), (2048, 1040), (4480, 16)])
def test_update_deal_covers_each_block_once(n, b0, C):
    """One trailing update's 16 x 16 blocks (rows and columns b0..n, the
    border row n included; those on and below the diagonal) each go to
    exactly one block of the cluster, and the chunk pairs are dealt so
    that no block holds more than its share plus one pair's."""
    deal = update_deal(n, b0, C)
    got = sorted(t for tiles in deal.values() for t in tiles)
    want = sorted((r, c) for r in range(b0, n + 1, 16)
                  for c in range(b0, r + 1, 16))
    assert got == want
    H = 128 if C == 1 else 64
    sizes = [len(t) for t in deal.values()]
    assert max(sizes) - min(sizes) <= 2 * (H // 16) ** 2


@pytest.mark.parametrize("C", (1, 2, 4, 8, 16))
def test_column_deal_covers_each_tile_once(C):
    """A chunk of C * 256 columns of L^-1's or K^-1's row panel: its 8-wide
    column tiles each go to exactly one warp of one block, four a warp; on
    one block warp w keeps the tiles of the one-block design (2 w, 2 w + 1,
    2 w + 16, 2 w + 17), and on a cluster each block's tiles spread over
    the whole chunk."""
    deal = column_deal(C)
    tiles = sorted(t for ts in deal.values() for t in ts)
    assert tiles == list(range(32 * C))
    assert all(len(ts) == 4 for ts in deal.values())
    if C == 1:
        assert all(deal[(0, w)] == [2 * w, 2 * w + 1, 2 * w + 16, 2 * w + 17]
                   for w in range(8))
    for rank in range(C):
        mine = [t for (r, _), ts in deal.items() if r == rank for t in ts]
        assert min(mine) < 2 * C and max(mine) >= 32 * C - 2 * C
