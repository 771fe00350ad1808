"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own ``nvcc`` process, all started together,
into a shared library with a plain C interface, and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -lineinfo
         -shared -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>.so
         csrc/<name>.cu

The build happens at first use, never at import, into ``build/kernels/``
beside the package (git-ignored); a library newer than its sources is
reused. A failed build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each kernel's launcher: every pointer and the stream as
# c_void_p (a bare Python int would be passed as a 32-bit int).
SIGNATURES = {
    "moment_sums": ("quatro_moment_sums",
                    [_P, _P, _I, _I, _F, _P, _P, _P, _P]),
    "spfh": ("quatro_spfh", [_P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P]),
    "fpfh": ("quatro_fpfh", [_P, _P, _P, _I, _I, _F, _P, _P, _I, _P, _P]),
    "nn2": ("quatro_nn2", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P]),
    "nn1": ("quatro_nn1", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P]),
    "consistency_graph": ("quatro_consistency_graph",
                          [_P, _P, _I, _I, _F, _P, _P]),
    "segment_sums": ("quatro_segment_sums",
                     [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "cross_histogram": ("quatro_cross_histogram",
                        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "fit_iteration_moments": ("quatro_fit_iteration_moments",
                              [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                               _P, _P]),
    "classify_points": ("quatro_classify_points",
                        [_P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "image_lookup": ("quatro_image_lookup", [_P, _P, _I, _I, _I, _P, _P]),
    "table_lookup": ("quatro_table_lookup", [_P, _P, _I, _I, _I, _I, _P, _P]),
    "exact_clique": ("quatro_exact_clique",
                     [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]),
    "kabsch": ("quatro_kabsch", [_P, _P, _P, _I, _I, _P, _P]),
    "label_sweep": ("quatro_label_sweep",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                     _P]),
    "overlap_hits": ("quatro_overlap_hits",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    "range_image": ("quatro_range_image_keys",
                    [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P,
                     _P, _P, _P, _P, _P, _P, _P]),
    "edge_masks": ("quatro_edge_masks",
                   [_P, _P, _I, _I, _I, _I, _P, _I, _P, _F, _F, _F, _F, _F,
                    _P, _P]),
    "component_stats": ("quatro_component_stats",
                        [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P]),
    "czm_points": ("quatro_czm_points",
                   [_P, _P, _I, _I, _I, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                    _P, _P, _P, _P, _P, _P, _P, _P]),
    "plane_fit": ("quatro_plane_fit",
                  [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _F, _P, _P,
                   _P, _P]),
    "cliques": ("quatro_kcore_search", [_P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "knn": ("quatro_radius_knn", [_P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _I,
                                  _P, _P, _P, _P]),
    "neighbor_normals": ("quatro_neighbor_normals",
                         [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P,
                          _P]),
    "icp": ("quatro_icp_correspond",
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P,
             _P, _P]),
    "match_candidates": ("quatro_match_candidates",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P, _P, _P]),
    "tuple_test": ("quatro_tuple_compact",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _F, _F, _I, _P, _P, _P, _P, _P, _P]),
    "voxel": ("quatro_voxel_keys", [_P, _P, _P, _I, _I, _F, _P, _P, _P]),
    "polish": ("quatro_polish_chain",
               [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                _P, _P, _P]),
    "moment_normals": ("quatro_moment_normals",
                       [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P]),
    "ground": ("quatro_ground_fit",
               [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P,
                _P, _P]),
    "vote": ("quatro_vote_entries",
             [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P]),
}

# Further C functions of a kernel's library: name -> (source, symbol,
# argument types). B1's library also exports the exhaustive check of its
# square root against __fsqrt_rn; the labelling's library, the cluster
# layout it picks for a batch; the range image's, its owner kernel (after
# the sort); the plane fit's, the seed heights' kernel; the cliques', the
# graph's packing, the growth, the swaps, the distinct greedy and the
# shared memory each kernel takes; ICP's, the update kernel; the voxel
# grid's, the selection and the centroids; the polish's, the yaw GNC and
# COTE (the polish's, and on given points); the vote's, the yaw modes and
# the translation vote's candidates after B2.
EXTRA = {"sqrt_rn_check": ("consistency_graph", "quatro_sqrt_rn_check",
                           [_P, _P]),
         "label_layout": ("label_sweep", "quatro_label_layout",
                          [_I, _I, _I, _P]),
         "range_image_owner": ("range_image", "quatro_range_image_owner",
                               [_P, _P, _I, _I, _I, _I, _P, _P, _P]),
         "seed_heights": ("plane_fit", "quatro_seed_heights",
                          [_P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P,
                           _P]),
         "clique_pack": ("cliques", "quatro_clique_pack",
                         [_P, _I, _I, _P, _P, _P]),
         "grow_cliques": ("cliques", "quatro_grow_cliques",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P]),
         "swap_cliques": ("cliques", "quatro_swap_cliques",
                          [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
         "distinct_cliques": ("cliques", "quatro_distinct_cliques",
                              [_P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P,
                               _P]),
         "clique_smem": ("cliques", "quatro_clique_smem",
                         [_I, _I, _I, _I, _P]),
         "icp_update": ("icp", "quatro_icp_update",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P,
                         _P]),
         "voxel_select": ("voxel", "quatro_voxel_select",
                          [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
         "voxel_centroids": ("voxel", "quatro_voxel_centroids",
                             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _F, _P, _P, _P, _P, _P, _P]),
         "gnc_yaw": ("polish", "quatro_gnc_yaw",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _F, _I,
                      _F, _P, _P, _P, _P, _P, _P, _P]),
         "polish_cote": ("polish", "quatro_polish_cote",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                          _P]),
         "cote": ("polish", "quatro_cote",
                  [_P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P, _I, _P]),
         "vote_translation": ("vote", "quatro_vote_translation",
                              [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _F, _F, _I, _P, _P, _P])}

_loaded: dict = {}
build_log: dict = {}    # name -> {"seconds": s, "ptxas": text}; last build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _stale(lib: Path, src: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def build(names=None, force: bool = False) -> dict:
    """Compile the named kernels (default: all) in parallel; return
    ``build_log``. Raises RuntimeError with nvcc's output on failure."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src = CSRC / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        if not force and not _stale(lib, src):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-lineinfo", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, lib)
        ptxas = "\n".join(line for line in out.splitlines()
                          if "registers" in line or "spill" in line
                          or "Compiling entry" in line)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": ptxas}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return build_log


def load(name: str):
    """The ctypes function of kernel ``name`` (or of ``EXTRA``), building
    its library if needed."""
    fn = _loaded.get(name)
    if fn is None:
        source, symbol, argtypes = EXTRA.get(name) or (name, *SIGNATURES[name])
        build([source])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{source}.so"))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
