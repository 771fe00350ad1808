"""The exact clique search of one restricted graph on the host: the
independent oracle for the steps, masks and ``completed`` of
``quatro_tpu_torch.ops.kernels.exact_clique`` (tests/test_torch_exact_so3.py)
and the host route that chip_smoke.py times beside the kernel; and the
clique stage's four kernels (csrc/cliques.cu) as host walks
(tests/test_torch_cliques.py). It imports neither JAX nor torch."""

import numpy as np


def host_dfs(sub, vvalid, best0, max_steps):
    """The search on one restriction as a walk over Python-int bitsets
    (bit i is restricted vertex i, the first candidate the lowest set
    bit), with a Python list as the frame stack: (best (cap,) bool,
    completed, steps)."""
    cap = len(vvalid)

    def bits(row):
        return sum(1 << i for i in range(cap) if row[i])

    nbr = [bits(r) for r in sub]
    best = bits(best0)
    best_size = best.bit_count()
    stack = [(bits(vvalid), 0)]                 # (candidates, clique)
    steps = 0
    while stack and steps < max_steps:
        p, c = stack.pop()
        csz, psz = c.bit_count(), p.bit_count()
        if csz > best_size:
            best, best_size = c, csz
        if csz + psz > best_size and psz > 0:
            vm = p & -p                         # the lowest vertex of P
            stack.append((p & ~vm, c))          # exclude it, explored later
            stack.append((p & nbr[vm.bit_length() - 1], c | vm))
        steps += 1
    out = np.array([(best >> i) & 1 for i in range(cap)], bool) & vvalid
    return out, not stack, steps


# --------------------------------------------------------------------------
# The clique stage's kernels (quatro_tpu_torch/csrc/cliques.cu) as walks
# over Python-int bitsets, step for step in the kernels' order: each pair,
# and in the growth each seed, to its own exit. tests/test_torch_cliques.py
# holds them against the port's plain routes and the JAX package, which is
# what the kernels' design rests on: the seeds of a pair are independent,
# the swap's cliques too, and a seed's rounds end at its own limit.

def _bits(row):
    return sum(1 << i for i, v in enumerate(row) if v)


def _members(x):
    while x:
        low = x & -x
        yield low.bit_length() - 1
        x ^= low


def _unbits(x, n):
    return np.array([(x >> i) & 1 for i in range(n)], bool)


def _desc(keys):
    """Indices in stable descending order of ``keys`` (NaN first)."""
    return sorted(range(len(keys)),
                  key=lambda i: (not np.isnan(keys[i]),
                                 -keys[i] if not np.isnan(keys[i]) else 0.0))


def host_kcore(adj, mask):
    """(lo, core (N,) bool, deg (N,) int) of one graph: the degrees over
    the mask, then the binary search, each probe peeling from the best
    core to its fixed point."""
    n = len(mask)
    rows = [_bits(r) for r in adj]
    m = _bits(mask)
    deg = [(rows[i] & m).bit_count() for i in range(n)]
    hi = max((deg[i] for i in _members(m)), default=0)
    lo, best = 0, m
    while lo < hi:
        mid = (lo + hi + 1) // 2
        cur = best
        while True:
            nxt = sum(1 << i for i in _members(cur)
                      if (rows[i] & cur).bit_count() >= mid)
            if nxt == cur:
                break
            cur = nxt
        if cur:
            lo, best = mid, cur
        else:
            hi = mid - 1
    return lo, _unbits(best, n), np.array(deg)


def host_grow(adj, scores, mask, num_seeds, max_size, phase1_rounds,
              survivors, tiebreak):
    """(S, N) bool cliques of one graph: each seed on its own while its
    candidate sum is positive, the degree of a candidate down its column,
    the pick's f32 score deg + tiebreak (``tiebreak`` f32), phase 2's
    survivors by candidates left. The seed v's own entries of the plain
    version's f32 vectors are kept apart (sigma, kappa: a seed on a self
    loop)."""
    n = len(mask)
    rows = [_bits(r) for r in adj]
    cols = [_bits(c) for c in np.asarray(adj).T]
    mb = _bits(mask)
    s_cnt = min(num_seeds, n)
    sc = np.where(mask, np.asarray(scores, np.float32), np.float32(-np.inf))
    seeds = _desc(sc)[:s_cnt]

    def grow(st, limit):
        v, cand, clq, csize, rounds, sigma, kappa = st
        vself = (rows[v] >> v) & 1
        while rounds < limit:
            csz = cand.bit_count() + sigma
            if csz <= 0:
                break
            esum, best, bj = 0, -np.inf, n
            for j in _members(cand):
                d = (cols[j] & cand).bit_count() + sigma * ((rows[v] >> j) & 1)
                esum += d
                score = np.float32(d) + np.float32(tiebreak[j])
                if score > best:
                    best, bj = score, j
            if sigma:
                deg_v = sigma * ((cols[v] & cand).bit_count() + sigma * vself)
                esum += deg_v
                score = np.float32(deg_v) + np.float32(tiebreak[v])
                if sigma > 0 and (score > best or (score == best and v < bj)):
                    best, bj = score, v
            if esum == csz * (csz - 1) and csize + csz <= max_size:
                clq, cand, csize = clq | cand, 0, csize + csz
                kappa, sigma = kappa + sigma, 0
            elif csize < max_size:
                if bj == v:
                    kappa += 1
                else:
                    clq |= 1 << bj
                cand, csize = cand & rows[bj] & ~clq, csize + 1
                sigma *= ((rows[bj] >> v) & 1) * (1 - kappa)
            else:
                cand, sigma = 0, 0
            rounds += 1
        return [v, cand, clq, csize, rounds, sigma, kappa]

    two_phase = not (s_cnt <= survivors or phase1_rounds >= max_size)
    states = [grow([v, rows[v] & mb & ~(1 << v), 0, 1, 0,
                    ((rows[v] >> v) & 1) * ((mb >> v) & 1), 1],
                   phase1_rounds if two_phase else max_size - 1)
              for v in seeds]
    if two_phase:
        promise = [st[1].bit_count() + st[5] for st in states]
        for s in _desc(np.array(promise, np.float64))[:survivors]:
            states[s] = grow(states[s], max_size - 1)
    out = np.zeros((len(states), n), bool)
    for s, (v, _, clq, _, _, _, kappa) in enumerate(states):
        out[s] = _unbits(clq, n)
        out[s, v] = kappa > 0
    return out


def host_swap(adj, cliques, mask, top, rounds, k_cand=128):
    """(S, N) bool: the ``top`` largest rows of one graph's cliques each
    improved on its own, up to ``rounds`` rounds: the first addable
    vertex, else the first pair of the k_cand lowest miss-one vertices
    that miss the same member."""
    n = len(mask)
    rows = [_bits(r) for r in adj]
    out = np.array(cliques, bool).copy()
    sizes = out.sum(1)
    for row in _desc(sizes.astype(np.float64))[:min(top, len(out))]:
        x = _bits(out[row])
        for _ in range(rounds):
            sz = x.bit_count()
            addable, miss, u = [], [], {}
            for j in range(n):
                if not mask[j] or (x >> j) & 1:
                    continue
                cnt = (rows[j] & x).bit_count()
                if cnt == sz:
                    addable.append(j)
                if cnt == sz - 1:
                    miss.append(j)
                    d = x & ~rows[j]
                    u[j] = (d & -d).bit_length() - 1
            if addable:
                x |= 1 << addable[0]
                continue
            cand = miss[:min(k_cand, n)]
            pair = next(((v1, v2) for v1 in cand for v2 in cand
                         if (rows[v1] >> v2) & 1 and u[v1] == u[v2]), None)
            if pair is None:
                break
            v1, v2 = pair
            x = (x & ~(1 << u[v1])) | (1 << v1) | (1 << v2)
        out[row] = _unbits(x, n)
    return out


def host_distinct(cliques, k, frac=0.5, force_first=False):
    """((k, N) bool, (k,) f32) of one pair's (S, N) cliques: the stable
    descending order of the sizes (row 0 first with force_first, its key
    size + 1e9 in f32), the greedy with its f32 test, the picks."""
    cliques = np.asarray(cliques, bool)
    s = len(cliques)
    k = min(k, s)
    packed = [_bits(r) for r in cliques]
    sizes = [p.bit_count() for p in packed]
    keys = np.array(sizes, np.float32)
    if force_first and s:
        keys[0] = np.float32(sizes[0]) + np.float32(1e9)
    order = _desc(keys.astype(np.float64))
    taken = []
    for i in range(s):
        if len(taken) >= k:
            break
        ri = order[i]
        if sizes[ri] <= 1:
            continue
        if not any(np.float32((packed[ri] & packed[order[t]]).bit_count())
                   >= np.float32(frac) * np.float32(
                       max(min(sizes[order[t]], sizes[ri]), 1))
                   for t in taken):
            taken.append(i)
    pick = taken + [i for i in range(s) if i not in taken][:k - len(taken)]
    masks = cliques[[order[p] for p in pick]].reshape(k, cliques.shape[1])
    out_sizes = np.array([sizes[order[p]] if q < len(taken) else 0
                          for q, p in enumerate(pick)], np.float32)
    return masks, out_sizes
