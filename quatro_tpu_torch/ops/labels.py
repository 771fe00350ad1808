"""The range-image labelling's min-label sweeps.

``preprocessing/projection.label_components`` spreads labels by rounds of
min-label sweeps (the ``lax.while_loop`` at
``quatro_tpu/preprocessing/projection.py:269``, its ``propagate`` and its
``sweep`` at :203, which XLA fuses into loop fusions; no Pallas kernel
there). ``label_sweeps`` runs that whole loop for a batch of images: one
launch of ``csrc/label_sweep.cu`` for CUDA tensors (one thread-block
cluster an image, every round and sweep in its distributed shared
memory, each image to its own exit; an image of few rows wider than a
cluster's shared memory holds in a global workspace instead, its route
counted "past" in ``SIZE_ROUTES["label_sweep"]``), counted in ``LAUNCHES
["label_sweep"]``; for CPU tensors ``label_sweeps_plain``, a
``while_chunks`` device loop of rounds of ``label_sweep_plain`` (the JAX
package's roll-doubling in torch operations). There is no fallback
between the two.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route)
from quatro_tpu_torch.utils import loops

MAX_SWEEPS = 8                  # edge masks a round (8Neighbor, 4CrossNeighbor)
# rounds per flag read of the plain route (label_sweeps_plain; the kernel
# reads no flag): 2, of 1, 2, 4 and 8 the fastest when that route ran on
# the H100 at B = 64, where a round past the exit cost ~1.4 ms of device
# work and a flag read ~0.3-0.5 ms of host wait (tests/torch_stage_busy.py
# --cc-chunks 1,2,4,8 on that route)
CC_CHUNK = 2
_NO_LAYOUT = 9                  # cudaErrorInvalidConfiguration


def roll_image(t: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """t shifted so that out[r, c] = t[r + dr, c + dc], both axes wrapping
    (jnp.roll(t, (-dr, -dc)) over the image axes)."""
    return torch.roll(t, shifts=(-dr, -dc), dims=(-2, -1))


def label_sweep_plain(labels: torch.Tensor, e: torch.Tensor, dr: int,
                      dc: int, steps: int, npix: int) -> torch.Tensor:
    """Min-label roll-doubling sweep along (dr, dc) over the edges ``e``.
    Wrapped contributions across the row boundary are masked: a gate that
    would cross it contains an edge the labelling's edge masks zeroed
    there."""
    best = torch.where(e, torch.minimum(labels, roll_image(labels, dr, dc)),
                       labels)
    gate = e
    s = 1
    for _ in range(steps - 1):
        cand = roll_image(best, dr * s, dc * s)
        best = torch.minimum(best, torch.where(gate, cand, npix))
        gate = gate & roll_image(gate, dr * s, dc * s)
        s *= 2
    return best


def _propagate_round(consts, state, sweeps, npix):
    """One round of ``label_sweeps_plain``'s device loop: every sweep in
    order, the invalid pixels back at ``npix``; the state (labels, each
    image still live, each image's rounds). An image counts a round while
    every round before it changed one of its labels."""
    valid, *masks = consts
    labels, live, rounds = state
    out = labels
    for e, (dr, dc, steps) in zip(masks, sweeps):
        out = label_sweep_plain(out, e, dr, dc, steps, npix)
    out = torch.where(valid, out, npix)
    changed = (out != labels).flatten(1).any(1)
    return out, live & changed, rounds + live.to(torch.int32)


def _any_live(state):
    return state[1].any()


def label_sweeps_plain(labels: torch.Tensor, valid: torch.Tensor, masks,
                       sweeps, max_iters: int, npix: int):
    """(labels, rounds (B,) int32): rounds of every sweep of ``sweeps``
    ((dr, dc, steps) each, over the matching edge mask of ``masks``), then
    ``where(valid, out, npix)``, until a round changes no label of any
    image or ``max_iters`` rounds; a ``while_chunks`` device loop
    (utils/loops.py, the JAX package's ``lax.while_loop``) reading its
    flag once per ``CC_CHUNK`` rounds. The rounds run past an image's exit
    change nothing: a round is a fixed point once it has changed none of
    the image's labels. rounds[b] counts image b's rounds as the JAX
    package's loop counts them on that image alone."""
    bsz = labels.shape[0]
    dev = labels.device

    def body(consts, state):
        return _propagate_round(consts, state, sweeps, npix)

    (out, _, rounds), _ = loops.while_chunks(
        "label_components", body, _any_live, (valid, *masks),
        (labels, torch.ones(bsz, dtype=torch.bool, device=dev),
         torch.zeros(bsz, dtype=torch.int32, device=dev)), max_iters,
        CC_CHUNK)
    return out, rounds


def label_sweeps(labels: torch.Tensor, valid: torch.Tensor, masks, sweeps,
                 max_iters: int, npix: int):
    """(labels (B, R, C) int32, rounds (B,) int32): the labelling's rounds
    of sweeps on (B, R, C) int32 initial labels, (B, R, C) bool ``valid``
    and one (B, R, C) bool edge mask per sweep of ``sweeps`` (at most
    MAX_SWEEPS), all contiguous. One launch of csrc/label_sweep.cu for
    CUDA tensors, every image to its own exit, bit for bit
    ``label_sweeps_plain`` (an image that no cluster's shared memory holds
    runs in a global workspace: ``label_layout``'s "image_in" is
    "global"); that plain version for CPU tensors."""
    if labels.dim() != 3:
        raise ValueError(f"labels: expected (B, R, C), got "
                         f"{tuple(labels.shape)}")
    shape = tuple(labels.shape)
    bsz, rows, cols = shape
    check("labels", labels, shape, torch.int32)
    check("valid", valid, shape, torch.bool)
    masks, sweeps = list(masks), [tuple(s) for s in sweeps]
    if not 1 <= len(sweeps) <= MAX_SWEEPS or len(masks) != len(sweeps):
        raise ValueError(f"{len(masks)} masks for {len(sweeps)} sweeps: "
                         f"expected one a sweep, 1 to {MAX_SWEEPS}")
    for k, e in enumerate(masks):
        check(f"masks[{k}]", e, shape, torch.bool)
    for dr, dc, steps in sweeps:
        if not 1 <= steps <= 40:
            raise ValueError(f"steps must lie in [1, 40], got {steps}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if same_device(labels, valid, *masks).type != "cuda":
        return label_sweeps_plain(labels, valid, masks, sweeps, max_iters,
                                  npix)
    out = torch.empty_like(labels)
    rounds = torch.empty(bsz, dtype=torch.int32, device=labels.device)
    if labels.numel() == 0:
        return out, rounds.zero_()
    lay = label_layout(bsz, rows, cols)
    wide = lay["image_in"] == "global"
    work = (torch.empty(bsz * lay["cluster"] * lay["cta_bytes"],
                        dtype=torch.uint8, device=labels.device)
            if wide else 0)
    ptrs = torch.tensor([e.data_ptr() for e in masks], dtype=torch.int64)
    sched = torch.tensor(sweeps, dtype=torch.int32)
    launch("label_sweep", labels, valid, ptrs, sched, len(sweeps), bsz,
           rows, cols, int(npix), int(max_iters), out, rounds, work)
    LAUNCHES["label_sweep"] += 1
    size_route("label_sweep", wide)
    return out, rounds


def label_layout(bsz: int, rows: int, cols: int) -> dict:
    """The kernel's layout for ``bsz`` images of rows x cols on the
    current card, as csrc/label_sweep.cu chooses it: cluster size, where
    the image lives ("image_in": "shared", the cluster's shared memory, or
    "global", a workspace of ``cta_bytes`` a CTA, for an image of few rows
    wider than a cluster's shared memory holds), the bytes a CTA takes
    there (``smem_bytes`` 0 on the global route), resident clusters
    (cudaOccupancyMaxActiveClusters) and the limit of shared bytes a CTA.
    Needs the card."""
    from quatro_tpu_torch import _build
    info = torch.zeros(5, dtype=torch.int32)
    rc = _build.load("label_layout")(bsz, rows, cols, info.data_ptr())
    cluster, cta_bytes, resident, limit, wide = info.tolist()
    if rc == _NO_LAYOUT:
        raise ValueError(
            f"a {rows} x {cols} image fits no resident cluster of the "
            f"labelling kernel")
    if rc != 0:
        raise RuntimeError(f"label_layout: CUDA error {rc}")
    return {"cluster": cluster, "image_in": "global" if wide else "shared",
            "cta_bytes": cta_bytes, "smem_bytes": 0 if wide else cta_bytes,
            "resident_clusters": resident, "smem_limit": limit}
