"""The clique stage of the solver: the k-core search, the greedy growth,
the (1,2)-swap and the distinct-clique greedy.

The JAX package runs these as ``lax.while_loop``s and a ``fori_loop`` over
XLA fusions (``quatro_tpu/solver/clique.py:43-99, 102-193, 196-285,
400-450``; no Pallas kernel there). The port runs each as one kernel launch
for every pair of a batch, behind a wrapper in ``ops/czm.py``'s style:

- ``kcore_search``: csrc/cliques.cu's pack kernel (the bool adjacency as
  (B, N, ceil(N / 32)) int32 rows and columns, ``PackedGraph``), then its
  k-core kernel: the whole binary search over k of each pair, each probe
  peeling from the best core to its fixed point, and the degrees over the
  mask that the seed scores take;
- ``grow_cliques``: the two-phase greedy growth of every seed, in three
  launches (the seeds selected, a block a pair; a block a (pair, seed)
  for phase 1; a block a (pair, seed) for phase 2, the survivors growing
  on), each seed to its own exit;
- ``swap_cliques``: the 1-swap rounds of the ``top`` largest cliques;
- ``distinct_cliques``: the stable sort by size, the greedy over the rows
  and the picks, for the K hypotheses and the vote's calls.

The k-core search, the swaps and the distinct greedy take a block of 1024
threads a pair; its packed rows sit in shared memory where they fit
(``clique_layout``), else it reads them through L2. The growth reads them
through L1 / L2 at any N (``ROUTES["grow_cliques"]`` counts every call
"global").
For CUDA tensors a wrapper checks its inputs (ValueError), launches on the
current stream and counts the call in ``LAUNCHES``; for CPU tensors it runs
its plain version (``*_plain``, the torch device loops of utils/loops.py
that ran on the card before the kernels). There is no fallback between the
two, and the kernels equal their plain versions on the card bit for bit:
every degree is an exact count, the f32 tests are taken on the same f32
values, and the growth's early completion on exact counts in both (the
JAX package's f32 sums equal them while a candidate set holds at most
GROW_EXACT vertices, and round past it).

The graph is packed once a solve: ``kcore_search`` packs it (its first
kernel, counted with it) and hands the bits on; the growth and the swaps on
the card take them and pack nothing.

Every function takes a leading pair axis (B, N, N); the public functions
of ``solver/clique.py`` add it for one graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route)
from quatro_tpu_torch.utils import fused, loops

KCORE_CHUNK = 8         # peel rounds per flag read (plain version)
GROW_CHUNK = 8          # growth rounds per flag read (plain version)
TOP_CHUNK = 32          # rows of the distinct greedy per graph (plain)
SWAP_CAND = 128         # the swap's k_cand: miss-one vertices it pairs
# the largest candidate set whose early-completion test the JAX package
# takes on exact f32 sums (csz^2 <= 2^24); the port's counts are exact at
# any size
GROW_EXACT = 4096
KIND = {"kcore_search": 0, "grow_cliques": 1, "swap_cliques": 2,
        "distinct_cliques": 3}
# which layout each kernel's last call took: the packed rows staged in
# shared memory ("shared") or read through L2 ("global"), calls counted
ROUTES = {name: {"shared": 0, "global": 0} for name in KIND}


class PackedGraph(NamedTuple):
    """A batch's adjacency as bits: rows[b, i, w] bit t = adj[b, i, 32 w +
    t], cols[b, j, w] bit t = adj[b, 32 w + t, j]; (B, N, ceil(N / 32))
    int32 each."""
    rows: torch.Tensor
    cols: torch.Tensor


def reset_routes() -> None:
    for counts in ROUTES.values():
        counts["shared"] = counts["global"] = 0


# --------------------------------------------------------------- helpers --

def _count_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counting matmul over 0/1 operands: f32 products of 0/1 values give
    exact integer counts (below 2**24; TF32 is never enabled)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _count_mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_count_mm`` of (..., N, N) matrices and (..., N) vectors."""
    return _count_mm(a, v[..., None])[..., 0]


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties toward
    the lower index (lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i], :] of (B, S, N) rows by (B, K) indices."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _put_rows(x: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """x with rows idx[b, i] replaced by rows[b, i] (distinct indices)."""
    return x.scatter(-2, idx[..., None].expand(*idx.shape, x.shape[-1]),
                     rows)


@functools.lru_cache(maxsize=16)
def _tiebreak(n: int, device: torch.device) -> torch.Tensor:
    """The growth's tiebreak -j * 1e-6 (f32, the scalar rounded as torch
    rounds it), made once per width and device."""
    return -torch.arange(n, dtype=torch.float32, device=device) * 1e-6


@functools.lru_cache(maxsize=64)
def clique_layout(kind: int, n: int, s: int, k: int, device_index: int):
    """(staged, bytes, limit) of a kernel of csrc/cliques.cu: whether its
    packed rows fit in a block's shared memory, the dynamic shared bytes it
    then takes, and the card's limit. ValueError where even the kernel's
    other shared arrays exceed it. Needs the card."""
    from quatro_tpu_torch import _build
    info = torch.zeros(3, dtype=torch.int32)
    with torch.cuda.device(device_index):
        rc = _build.load("clique_smem")(kind, n, s, k, info.data_ptr())
    if rc != 0:
        raise RuntimeError(f"clique_smem: CUDA error {rc}")
    staged, bare, limit = info.tolist()
    if bare > limit:
        raise ValueError(
            f"clique kernel {kind} at N = {n}, S = {s}: {bare} bytes of "
            f"shared memory a block without the rows, over the limit "
            f"{limit}")
    return (True, staged, limit) if staged <= limit else (False, bare, limit)


def _route(name: str, n: int, s: int = 0, k: int = 0, dev=None) -> int:
    staged = clique_layout(KIND[name], n, s, k, dev.index or 0)[0]
    ROUTES[name]["shared" if staged else "global"] += 1
    return int(staged)


def _check_graph(adj, mask):
    if adj.dim() != 3 or adj.shape[-1] != adj.shape[-2]:
        raise ValueError(f"adj: expected (B, N, N), got {tuple(adj.shape)}")
    bsz, n = adj.shape[:2]
    check("adj", adj, (bsz, n, n), torch.bool)
    check("mask", mask, (bsz, n), torch.bool)
    return bsz, n


def pack_graph(adj: torch.Tensor) -> PackedGraph:
    """The bits of a (B, N, N) bool adjacency on the card: one launch of
    csrc/cliques.cu's pack kernel, made and counted by ``kcore_search``
    alone."""
    bsz, n = adj.shape[:2]
    w = -(-n // 32)
    rows, cols = (torch.empty((bsz, n, w), dtype=torch.int32,
                              device=adj.device) for _ in range(2))
    launch("clique_pack", adj, bsz, n, rows, cols)
    return PackedGraph(rows, cols)


def _check_packed(adj, packed):
    if packed is None:
        raise ValueError("packed: the graph's bits from kcore_search are "
                         "needed on the card")
    w = -(-adj.shape[-1] // 32)
    for name, t in zip(packed._fields, packed):
        check(f"packed.{name}", t, (*adj.shape[:2], w), torch.int32)
    return packed


# --------------------------------------------------------- k-core search --

def _kcore_round(consts, state):
    """One peel round of every pair's current probe of the binary search.
    A pair whose peel did not change this round has reached its probe's
    fixed point: it resolves the probe (lo or hi, and the best core when
    the core is non-empty) and starts its next probe from its best core.
    A pair whose search has ended probes k = 0, which peels nothing, so
    its state is a fixed point of the round."""
    (adj_f,) = consts
    lo, hi, best, alive = state
    act = lo < hi
    mid = (lo + hi + 1) // 2
    k = torch.where(act, mid, 0).to(torch.float32)
    deg = _count_mv(adj_f, alive)
    peeled = alive * (deg >= k[..., None]).to(alive.dtype)
    done = ~(peeled != alive).any(-1)
    nonempty = act & done & (peeled.sum(-1) > 0)
    lo = torch.where(nonempty, mid, lo)
    hi = torch.where(act & done & ~nonempty, mid - 1, hi)
    best = torch.where(nonempty[..., None], peeled, best)
    alive = torch.where(done[..., None], best, peeled)
    return lo, hi, best, alive


def _searching(state):
    return (state[0] < state[1]).any()


def kcore_search_plain(adj: torch.Tensor, mask: torch.Tensor):
    """``kcore_search`` in torch operations: the binary search and its
    peels as one flat device loop of peel rounds (utils/loops.py), a flag
    read per KCORE_CHUNK rounds; each pair resolves its own probe in the
    round its peel stops changing and starts its next probe in the next.
    A k-core peel's fixed point is unique and the degrees are exact
    counts, so each pair's (lo, best core) is the JAX package's nested
    loops' (quatro_tpu/solver/clique.py:61, :97) bit for bit. Each probe
    removes at most N vertices, a round at least one until it ends, and
    there are at most bit_length(N) + 1 probes: that bounds the rounds."""
    n = adj.shape[-1]
    adj_f = adj.to(torch.float32)
    alive0 = mask.to(torch.float32)
    deg0 = _count_mv(adj_f, alive0)
    lo = torch.zeros(mask.shape[:-1], dtype=torch.int64, device=adj.device)
    hi = torch.where(mask, deg0, 0.0).amax(-1).to(torch.int64)
    (lo, _, best_core, _), _ = loops.while_chunks(
        "max_kcore", _kcore_round, _searching, (adj_f,),
        (lo, hi, alive0, alive0), (n + 1) * (n.bit_length() + 1),
        KCORE_CHUNK)
    return lo, best_core > 0, deg0


def kcore_search(adj: torch.Tensor, mask: torch.Tensor):
    """Largest k with a non-empty k-core of each pair's graph and that
    core, plus the degrees over the mask: adj (B, N, N), mask (B, N), both
    bool and contiguous -> (lo (B,) int64, core (B, N) bool, deg (B, N)
    f32 = adj @ mask, packed: the graph's bits for ``grow_cliques`` and
    ``swap_cliques``). For CUDA tensors the pack kernel and the k-core
    kernel of csrc/cliques.cu, one block a pair, bit for bit
    ``kcore_search_plain``, which runs for CPU tensors (``packed`` None)."""
    bsz, n = _check_graph(adj, mask)
    if same_device(adj, mask).type != "cuda":
        return (*kcore_search_plain(adj, mask), None)
    dev = adj.device
    lo = torch.empty(bsz, dtype=torch.int64, device=dev)
    core = torch.empty((bsz, n), dtype=torch.bool, device=dev)
    deg = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    if bsz == 0 or n == 0:
        return lo, core, deg, None
    packed = pack_graph(adj)
    launch("cliques", packed.rows, mask, bsz, n,
           _route("kcore_search", n, dev=dev), lo, core, deg)
    LAUNCHES["kcore_search"] += 1
    return lo, core, deg, packed


# ---------------------------------------------------------------- growth --

def _grow_round(consts, state, max_size: int, n: int):
    """One lock-step growth round of every seed (see ``grow_cliques``); a
    seed with no candidate left is a fixed point."""
    adj_f, tiebreak = consts
    clique, cand = state
    deg = _count_mm(cand, adj_f) * cand
    # early completion: a candidate set that is itself a clique is
    # absorbed whole (never past max_size). The test is taken on exact
    # counts (f64 holds them), as the kernel takes it: the JAX package's
    # f32 sums are exact up to GROW_EXACT candidates and round past it.
    csz = cand.sum(-1)
    esum = deg.to(torch.float64).sum(-1)
    csz64 = csz.to(torch.float64)
    room = clique.sum(-1) + csz <= float(max_size)
    whole = ((esum == csz64 * (csz64 - 1.0)) & (csz > 0) & room
             ).to(torch.float32)[..., None]
    clique = clique + cand * whole
    cand = cand * (1.0 - whole)
    score = torch.where(cand > 0, deg + tiebreak, float("-inf"))
    pick = torch.argmax(score, dim=-1)
    pick_oh = torch.nn.functional.one_hot(pick, n).to(torch.float32)
    has_cand = ((cand.sum(-1) > 0) & (clique.sum(-1) < float(max_size))
                )[..., None].to(torch.float32)
    clique = clique + pick_oh * has_cand
    cand = cand * _count_mm(pick_oh, adj_f) * has_cand
    cand = cand * (1.0 - clique)
    return clique, cand


def _has_candidates(state):
    return (state[1].sum(-1) > 0).any()


def grow_cliques_plain(adj: torch.Tensor, seed_scores: torch.Tensor,
                       mask: torch.Tensor, num_seeds: int, max_size: int,
                       phase1_rounds: int, survivors: int) -> torch.Tensor:
    """``grow_cliques`` in torch operations: the JAX package's
    ``lax.while_loop``s (quatro_tpu/solver/clique.py:177-190) as device
    loops (utils/loops.py) that read their flag, whether any seed of any
    pair has candidates, once per GROW_CHUNK rounds; a seed with no
    candidate left is a fixed point of a round, and a chunk never passes
    its phase's limit."""
    n = adj.shape[-1]
    dev = adj.device
    num_seeds = min(num_seeds, n)
    adj_f = adj.to(torch.float32)
    scores = torch.where(mask, seed_scores, float("-inf"))
    seeds = _top_k_indices(scores, num_seeds)               # (B, S)
    clique = torch.nn.functional.one_hot(seeds, n).to(torch.float32)
    cand = _take_rows(adj_f, seeds) * mask.to(torch.float32)[..., None, :]
    tiebreak = _tiebreak(n, dev)

    def body(consts, state):
        return _grow_round(consts, state, max_size, n)

    def run(clique, cand, rounds, limit):
        (clique, cand), trips = loops.while_chunks(
            "grow_cliques", body, _has_candidates, (adj_f, tiebreak),
            (clique, cand), limit - rounds, GROW_CHUNK)
        return clique, cand, rounds + trips

    if num_seeds <= survivors or phase1_rounds >= max_size:
        clique, _, _ = run(clique, cand, 0, max_size - 1)
        return clique > 0
    # phase 1 ends at its limit (r1 = phase1_rounds however it is
    # chunked) or with no candidates left in any pair, and then phase 2
    # is a fixed point whatever its round count
    clique, cand, r1 = run(clique, cand, 0, phase1_rounds)
    keep = _top_k_indices(cand.sum(-1), survivors)
    c2, _, _ = run(_take_rows(clique, keep), _take_rows(cand, keep), r1,
                   max_size - 1)
    return _put_rows(clique, keep, c2) > 0


def grow_cliques(adj: torch.Tensor, seed_scores: torch.Tensor,
                 mask: torch.Tensor, num_seeds: int = 16,
                 max_size: int = 512, phase1_rounds: int = 8,
                 survivors: int = 16,
                 packed: PackedGraph | None = None) -> torch.Tensor:
    """S = min(num_seeds, N) greedy cliques of each pair, (B, S, N) bool,
    from adj (B, N, N) bool, seed_scores (B, N) f32 and mask (B, N) bool,
    all contiguous: the seeds are the S best masked scores; each round
    adds, per seed, the candidate of highest degree within its candidate
    set (an early completion absorbs a candidate set that is a clique),
    all seeds phase1_rounds rounds and then the survivors of most
    candidates on (one phase where num_seeds <= survivors or phase1_rounds
    >= max_size), at most max_size - 1 rounds and max_size vertices. For
    CUDA tensors csrc/cliques.cu's growth on ``packed`` (``kcore_search``'s
    bits of adj): the seeds' selection, then a block a (pair, seed) for each
    phase (two launches in one phase, three in two), each pair and seed to
    its own exit, bit for bit ``grow_cliques_plain``, which runs for CPU
    tensors. Both take the early-completion test on exact counts; a
    candidate set above GROW_EXACT vertices reaches it only where N >
    GROW_EXACT and max_size > GROW_EXACT + 1, where the JAX package's f32
    sums round (such calls count as "past" in ``SIZE_ROUTES``)."""
    bsz, n = _check_graph(adj, mask)
    check("seed_scores", seed_scores, (bsz, n))
    if same_device(adj, seed_scores, mask).type != "cuda":
        return grow_cliques_plain(adj, seed_scores, mask, num_seeds,
                                  max_size, phase1_rounds, survivors)
    dev = adj.device
    s = max(min(num_seeds, n), 0)
    out = torch.empty((bsz, s, n), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    two_phase = not (s <= survivors or phase1_rounds >= max_size)
    packed = _check_packed(adj, packed)
    # each seed's record (candidate and clique bits, its state), the
    # seeds, the seed selection's 64-bit keys
    scratch = torch.empty(bsz * s * (2 * (-(-n // 32)) + 9) + 1,
                          dtype=torch.int32, device=dev)
    launch("grow_cliques", packed.rows, packed.cols, seed_scores, mask,
           _tiebreak(n, dev), bsz, n, s, int(max_size), int(phase1_rounds),
           max(int(survivors), 0) if two_phase else 0, int(two_phase),
           scratch, out)
    LAUNCHES["grow_cliques"] += 1
    ROUTES["grow_cliques"]["global"] += 1
    size_route("grow_cliques", n > GROW_EXACT and max_size > GROW_EXACT + 1)
    return out


# ------------------------------------------------------------------ swap --

def _swap_round(consts, state, k_cand: int):
    """One (1,2)-swap round of every clique (see ``swap_cliques``); a
    clique that is no longer live keeps its members."""
    adj_b, adj_t, mask, iota = consts
    x, live = state
    bsz, kq, n = x.shape
    xf = x.to(torch.float32)
    s = xf.sum(-1, keepdim=True)
    cnt = xf @ adj_t                       # neighbours inside the clique
    outside = ~x & mask[:, None, :]
    addable = (cnt == s) & outside
    can_add = addable.any(-1)
    add_idx = torch.argmax(addable.to(torch.uint8), -1, keepdim=True)
    x_add = x.scatter(-1, add_idx, True)
    miss1 = (cnt == s - 1.0) & outside
    sel_key = torch.where(miss1, iota, n)
    idx = torch.sort(sel_key, dim=-1, stable=True).indices[..., :k_cand]
    vsel = sel_key.gather(-1, idx) < n                    # (B, K, C)
    rows_b = _take_rows(adj_b, idx.reshape(bsz, -1)).reshape(
        bsz, kq, k_cand, n)                               # (B, K, C, N)
    asub = rows_b.gather(-1, idx[..., None, :].expand(
        bsz, kq, k_cand, k_cand))
    # the first member each selected vertex is not adjacent to
    uidx = torch.argmax((~rows_b & x[..., None, :]).to(torch.uint8), -1)
    pairs = (asub & vsel[..., :, None] & vsel[..., None, :]
             & (uidx[..., :, None] == uidx[..., None, :]))
    flat = pairs.reshape(bsz, kq, -1)
    pidx = torch.argmax(flat.to(torch.uint8), -1, keepdim=True)
    can_swap = flat.gather(-1, pidx)[..., 0]
    p_row, p_col = pidx // k_cand, pidx % k_cand
    x_swap = (x.scatter(-1, uidx.gather(-1, p_row), False)
              .scatter(-1, idx.gather(-1, p_row), True)
              .scatter(-1, idx.gather(-1, p_col), True))
    moved = can_add | can_swap
    new = torch.where(can_add[..., None], x_add, x_swap)
    x = torch.where((live & moved)[..., None], new, x)
    return x, live & moved


def swap_cliques_plain(adj: torch.Tensor, cliques: torch.Tensor,
                       mask: torch.Tensor, top: int,
                       rounds: int) -> torch.Tensor:
    """``swap_cliques`` in torch operations: the top rows' rounds, every
    clique of every pair together, as a device loop that reads nothing
    back (utils/loops.py), a clique that stopped frozen by its live mask
    (the JAX package's ``lax.while_loop`` under vmap,
    quatro_tpu/solver/clique.py:266)."""
    if rounds <= 0:
        return cliques.clone()
    bsz, s, n = cliques.shape
    dev = adj.device
    top = min(top, s)
    idx = _top_k_indices(cliques.sum(-1), top)
    adj_b = adj.to(torch.bool)
    adj_t = adj_b.to(torch.float32).transpose(-1, -2)
    k_cand = min(SWAP_CAND, n)
    iota = torch.arange(n, device=dev)
    live = torch.ones((bsz, top), dtype=torch.bool, device=dev)

    def body(consts, state):
        return _swap_round(consts, state, k_cand)

    x, _ = loops.fori("swap_cliques", body, (adj_b, adj_t, mask, iota),
                      (_take_rows(cliques, idx), live), rounds, rounds)
    return _put_rows(cliques, idx, x)


def swap_cliques(adj: torch.Tensor, cliques: torch.Tensor,
                 mask: torch.Tensor, top: int = 8, rounds: int = 4,
                 packed: PackedGraph | None = None) -> torch.Tensor:
    """The (1,2)-swap improvement of the ``top`` largest of each pair's S
    cliques (stable, ties to the lower row), adj (B, N, N), cliques (B, S,
    N), mask (B, N), all bool and contiguous -> (B, S, N): per round, add
    an outside vertex adjacent to every member, else drop one member u and
    add two adjacent outside vertices that miss only u (among the
    SWAP_CAND lowest miss-one vertices); a clique with neither stops
    there. For CUDA tensors one launch of csrc/cliques.cu's swap kernel on
    ``packed`` (``kcore_search``'s bits of adj), bit for bit
    ``swap_cliques_plain``, which runs for CPU tensors."""
    bsz, n = _check_graph(adj, mask)
    if cliques.dim() != 3:
        raise ValueError(f"cliques: expected (B, S, N), got "
                         f"{tuple(cliques.shape)}")
    s = cliques.shape[1]
    check("cliques", cliques, (bsz, s, n), torch.bool)
    rounds = max(int(rounds), 0)
    if same_device(adj, cliques, mask).type != "cuda":
        return swap_cliques_plain(adj, cliques, mask, top, rounds)
    out = torch.empty_like(cliques)
    if out.numel() == 0:
        return out
    packed = _check_packed(adj, packed)
    launch("swap_cliques", packed.rows, cliques, mask, bsz, n, s,
           max(min(int(top), s), 0), rounds,
           _route("swap_cliques", n, s, dev=adj.device), out)
    LAUNCHES["swap_cliques"] += 1
    return out


# -------------------------------------------------------------- distinct --

def _distinct_round(consts, state, k: int, frac: float):
    """Row i of the greedy over the sorted rows, for every pair: taken
    when fewer than k are taken, no taken row covers min_distinct_frac of
    the smaller of the two, and it is no singleton."""
    inter, sizes, iota = consts
    taken, count, i = state
    row = inter.index_select(-2, i)[..., 0, :]            # (B, S)
    size_i = sizes.index_select(-1, i)                    # (B, 1)
    min_sz = torch.minimum(sizes, size_i)
    conflict = taken & (row >= frac * torch.clamp(min_sz, min=1.0))
    # singletons (isolated seeds) carry no hypothesis: the reference
    # aborts on cliques <= 1 (include/quatro.hpp:809-813)
    ok = (count < k) & ~conflict.any(-1) & (size_i[..., 0] > 1)
    taken = taken | ((iota == i)[None, :] & ok[:, None])
    return taken, count + ok.to(count.dtype), i + 1


def distinct_cliques_plain(cliques: torch.Tensor, k: int,
                           min_distinct_frac: float = 0.5,
                           force_first: bool = False):
    """``distinct_cliques`` in torch operations: the JAX package's greedy
    ``fori_loop`` over the S sorted rows (quatro_tpu/solver/clique.py:
    433-442) as a device loop for every pair at once (utils/loops.py,
    TOP_CHUNK rows a graph), with nothing copied to the host."""
    bsz, s = cliques.shape[:2]
    k = min(k, s)
    dev = cliques.device
    cf = cliques.to(torch.float32)
    sizes = cf.sum(-1)
    sort_key = sizes
    if force_first:
        bump = torch.zeros_like(sizes)
        bump[..., 0] = 1e9
        sort_key = sizes + bump
    order = torch.sort(-sort_key, dim=-1, stable=True).indices
    cf = _take_rows(cf, order)
    sizes = sizes.gather(-1, order)
    inter = _count_mm(cf, cf.transpose(-1, -2))          # (B, S, S)
    iota = torch.arange(s, device=dev)

    def body(consts, state):
        return _distinct_round(consts, state, k, min_distinct_frac)

    taken, count, _ = loops.fori(
        "top_distinct", body, (inter, sizes, iota),
        (torch.zeros((bsz, s), dtype=torch.bool, device=dev),
         torch.zeros(bsz, dtype=torch.int64, device=dev),
         torch.zeros(1, dtype=torch.int64, device=dev)), s, TOP_CHUNK)
    pick = torch.sort(torch.where(taken, iota, s + iota), dim=-1,
                      stable=True).indices[:, :k]
    filled = torch.arange(k, device=dev)[None, :] < count[:, None]
    picked_sizes = torch.where(filled, sizes.gather(-1, pick), 0.0)
    return _take_rows(cf, pick) > 0, picked_sizes


def distinct_cliques(cliques: torch.Tensor, k: int,
                     min_distinct_frac: float = 0.5,
                     force_first: bool = False):
    """The k = min(k, S) largest pairwise-distinct of each pair's cliques
    (B, S, N) bool, contiguous: ((B, k, N) bool masks, (B, k) f32 sizes).
    Two cliques are the same hypothesis when their intersection covers >=
    min_distinct_frac (rounded to f32) of the smaller one; singletons are
    never taken; with force_first, row 0 goes first whatever its size.
    Unfilled slots hold the first untaken rows with size 0. For CUDA
    tensors one launch of csrc/cliques.cu's distinct kernel, bit for bit
    ``distinct_cliques_plain``, which runs for CPU tensors."""
    if cliques.dim() != 3:
        raise ValueError(f"cliques: expected (B, S, N), got "
                         f"{tuple(cliques.shape)}")
    bsz, s, n = cliques.shape
    check("cliques", cliques, (bsz, s, n), torch.bool)
    if cliques.device.type != "cuda":
        return distinct_cliques_plain(cliques, k, min_distinct_frac,
                                      force_first)
    dev = cliques.device
    k = max(min(int(k), s), 0)
    out = torch.empty((bsz, k, n), dtype=torch.bool, device=dev)
    sizes = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    if bsz == 0 or k == 0 or n == 0:
        return out, sizes.zero_()
    staged = _route("distinct_cliques", n, s, k, dev)
    scratch = torch.empty(0 if staged else bsz * s * (-(-n // 32)),
                          dtype=torch.int32, device=dev)
    launch("distinct_cliques", cliques, bsz, s, n, k,
           fused.f32(min_distinct_frac), int(bool(force_first)), staged,
           scratch, out, sizes)
    LAUNCHES["distinct_cliques"] += 1
    return out, sizes
