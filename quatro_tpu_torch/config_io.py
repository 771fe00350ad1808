"""Reference-compatible YAML configuration loading.

PyTorch counterpart of ``quatro_tpu/config_io.py``. The reference loads two
YAML files into the ROS parameter server (launch/quatro.launch:3-4) and
reads them with ``nh.param`` (examples/run_global_registration.cpp:37-55,
include/patchwork.hpp:51-95). ``load_params_yaml`` accepts those schemas
unchanged and returns the port's ``PipelineConfig``.

The port does not depend on PyYAML. ``parse_yaml`` reads the subset of
YAML those files use, resolving scalars as PyYAML's ``safe_load`` does:
block maps nested by indentation, plain and quoted scalars (int, float,
bool, null, string), ``#`` comments and one-line flow lists ``[a, b]``.
Anything else raises ``ValueError`` with the line number: anchors and
aliases, tags, block lists, flow maps, multi-line scalars, tabs,
duplicate keys, and plain scalars that PyYAML would read as another type
this parser does not produce (hex, octal or sexagesimal numbers, dates).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from quatro_tpu_torch.config import LidarConfig, PipelineConfig

# PyYAML's implicit resolvers (YAML 1.1), for the forms produced here
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF_NAN = {".inf": float("inf"), ".Inf": float("inf"),
            ".INF": float("inf"), "+.inf": float("inf"),
            "+.Inf": float("inf"), "+.INF": float("inf"),
            "-.inf": float("-inf"), "-.Inf": float("-inf"),
            "-.INF": float("-inf"), ".nan": float("nan"),
            ".NaN": float("nan"), ".NAN": float("nan")}
# plain scalars PyYAML types in ways this parser does not reproduce
_UNSUPPORTED = re.compile(
    r"[-+]?0[0-7_]+$|[-+]?0b[01_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?$"
    r"|[-+]?[0-9.][0-9._]*_[0-9._]*(?:[eE][-+][0-9]+)?$|=$|<<$")
_INDICATORS = "&*!|>{}[]%@`,"


def _fail(lineno: int, what: str):
    raise ValueError(f"config YAML line {lineno}: {what}")


def _strip_comment(text: str, lineno: int) -> str:
    """The line without its comment: a '#' at the start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or text[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        _fail(lineno, "a quoted scalar that does not close on its line "
                      "(multi-line scalars are not supported)")
    return text.rstrip()


def _scalar(tok: str, lineno: int):
    """One scalar token, resolved as PyYAML's safe_load resolves it."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        body = tok[1:-1]
        if "\\" in body or '"' in body:
            _fail(lineno, f"escapes in double-quoted scalar {tok}")
        return body
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        body = tok[1:-1]
        if "'" in body.replace("''", ""):
            _fail(lineno, f"malformed single-quoted scalar {tok}")
        return body.replace("''", "'")
    if tok[:1] in "\"'":
        _fail(lineno, f"unterminated quoted scalar {tok}")
    if tok[:1] in _INDICATORS or tok.startswith(("- ", "? ")) \
            or tok in ("-", "?"):
        _fail(lineno, f"unsupported YAML construct {tok!r} (anchors, "
                      "aliases, tags, block scalars, flow maps and block "
                      "lists are not supported)")
    if ": " in tok or tok.endswith(":"):
        _fail(lineno, f"a mapping inside the value {tok!r}")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if tok in _INF_NAN:
        return _INF_NAN[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok) and tok not in (".", "+.", "-."):
        return float(tok)
    if _UNSUPPORTED.match(tok):
        _fail(lineno, f"plain scalar {tok!r} would be typed by YAML in a "
                      "way this parser does not support; quote it")
    return tok


def _flow_list(tok: str, lineno: int) -> list:
    if not tok.endswith("]"):
        _fail(lineno, "a flow list that does not close on its line")
    body = tok[1:-1].strip()
    if "[" in body or "]" in body or "{" in body:
        _fail(lineno, "nested flow collections are not supported")
    if not body:
        return []
    items = [s.strip() for s in body.split(",")]
    if items[-1] == "":               # a trailing comma, as YAML allows
        items.pop()
    if any(s == "" for s in items):
        _fail(lineno, "an empty entry in a flow list")
    return [_scalar(s, lineno) for s in items]


def _key_value(text: str, lineno: int):
    """Split 'key: value' (or 'key:') into the key and the value text."""
    if text[:1] in "\"'":
        end = text.find(text[0], 1)
        if end < 0:
            _fail(lineno, "unterminated quoted key")
        key, rest = text[1:end], text[end + 1:]
        if not (rest == ":" or rest.startswith(": ")):
            _fail(lineno, f"expected 'key: value', got {text!r}")
        return key, rest[1:].strip()
    m = re.match(r"([^:#]*?[^\s:])\s*:(?:\s+(.*))?$", text)
    if not m:
        if text.startswith(("- ", "-")) and not text.startswith("---"):
            _fail(lineno, "block lists are not supported; use a flow "
                          "list [a, b]")
        _fail(lineno, f"expected 'key: value', got {text!r} (multi-line "
                      "scalars are not supported)")
    key = m.group(1).strip()
    if not isinstance(_scalar(key, lineno), str):
        _fail(lineno, f"key {key!r} is not a string; quote it")
    return key, (m.group(2) or "").strip()


def parse_yaml(text: str):
    """Parse ``text`` (the subset above) into nested dicts, lists and
    scalars, as ``yaml.safe_load`` does; an empty document is None."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw, lineno)
        if not body.strip():
            continue
        if "\t" in body[:len(body) - len(body.lstrip())]:
            _fail(lineno, "tab in indentation")
        if body in ("---", "...") or body.startswith("%"):
            if lines or body != "---":
                _fail(lineno, f"document marker or directive {body!r}: one "
                              "document without directives is supported")
            continue
        lines.append((lineno, len(body) - len(body.lstrip(" ")),
                      body.strip()))
    if not lines:
        return None
    root: dict = {}
    stack = [(-1, root)]            # (indent of the map's keys, map)
    pending = None                  # (indent, map, key) of a bare 'key:'
    for lineno, indent, body in lines:
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:   # the bare key opens a nested map
                child: dict = {}
                p_map[p_key] = child
                stack.append((indent, child))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if len(stack) == 1 and not root:
                stack[0] = (indent, root)
            else:
                _fail(lineno, "indentation does not match any enclosing "
                              "block (multi-line scalars are not supported)")
        key, value = _key_value(body, lineno)
        cur = stack[-1][1]
        if key in cur:
            _fail(lineno, f"duplicate key {key!r}")
        if value == "":
            cur[key] = None
            pending = (indent, cur, key)
        elif value.startswith("["):
            cur[key] = _flow_list(value, lineno)
        else:
            cur[key] = _scalar(value, lineno)
    return root


def _load(path: str) -> dict:
    with open(path) as f:
        doc = parse_yaml(f.read())
    if doc is not None and not isinstance(doc, dict):
        raise ValueError(f"{path}: the top level is not a mapping")
    return doc or {}


def load_params_yaml(params_path: Optional[str] = None,
                     patchwork_path: Optional[str] = None,
                     base: Optional[PipelineConfig] = None) -> PipelineConfig:
    """Build a PipelineConfig from the reference's YAML files.

    Either file may be omitted; missing keys keep the defaults of `base`
    (which mirror the reference's own defaults).
    """
    cfg = base if base is not None else PipelineConfig()
    lidar, fpfh, solver, patchwork = (cfg.lidar, cfg.fpfh, cfg.solver,
                                      cfg.patchwork)
    ground_mode = cfg.ground_segmentation_mode
    neighbor_mode = cfg.projection.neighbor_mode
    voxel_size = cfg.voxel_size

    if params_path:
        p = _load(params_path)
        if "Lidar_type" in p:
            lidar = LidarConfig.preset(p["Lidar_type"])
        ground_mode = p.get("ground_segmentation_mode", ground_mode)
        neighbor_mode = p.get("neigbor_mode", neighbor_mode)  # sic: reference key
        voxel_size = float(p.get("voxel_size", voxel_size))
        f_yaml = p.get("FPFH", {}) or {}
        fpfh = dataclasses.replace(
            fpfh,
            normal_radius=float(f_yaml.get("normal_radius",
                                           fpfh.normal_radius)),
            fpfh_radius=float(f_yaml.get("fpfh_radius", fpfh.fpfh_radius)))
        q = p.get("Quatro", {}) or {}
        rot = q.get("rotation", {}) or {}
        solver = dataclasses.replace(
            solver,
            estimate_scaling=bool(q.get("estimating_scale",
                                        solver.estimate_scaling)),
            noise_bound=float(q.get("noise_bound", solver.noise_bound)),
            cbar2=float(q.get("noise_bound_coeff", solver.cbar2)),
            rotation_max_iterations=int(rot.get(
                "num_max_iter", solver.rotation_max_iterations)),
            rotation_gnc_factor=float(rot.get("gnc_factor",
                                              solver.rotation_gnc_factor)),
            rotation_cost_threshold=float(rot.get(
                "rot_cost_diff_thr", solver.rotation_cost_threshold)))

    if patchwork_path:
        pw = _load(patchwork_path)
        flat = pw.get("patchwork", {}) or {}
        czm = flat.get("czm", {}) or {}
        patchwork = dataclasses.replace(
            patchwork,
            sensor_height=float(pw.get("sensor_height",
                                       patchwork.sensor_height)),
            num_iter=int(flat.get("num_iter", patchwork.num_iter)),
            num_lpr=int(flat.get("num_lpr", patchwork.num_lpr)),
            num_min_pts=int(flat.get("num_min_pts", patchwork.num_min_pts)),
            th_seeds=float(flat.get("th_seeds", patchwork.th_seeds)),
            th_dist=float(flat.get("th_dist", patchwork.th_dist)),
            max_r=float(flat.get("max_r", patchwork.max_r)),
            min_r=float(flat.get("min_r", patchwork.min_r)),
            uprightness_thr=float(flat.get("uprightness_thr",
                                           patchwork.uprightness_thr)),
            adaptive_seed_selection_margin=float(flat.get(
                "adaptive_seed_selection_margin",
                patchwork.adaptive_seed_selection_margin)),
            using_global_elevation=bool(flat.get(
                "using_global_elevation", patchwork.using_global_elevation)),
            global_elevation_threshold=float(flat.get(
                "global_elevation_threshold",
                patchwork.global_elevation_threshold)),
            num_zones=int(czm.get("num_zones", patchwork.num_zones)),
            num_sectors_each_zone=tuple(czm.get(
                "num_sectors_each_zone", patchwork.num_sectors_each_zone)),
            num_rings_each_zone=tuple(czm.get(
                "num_rings_each_zone", patchwork.num_rings_each_zone)),
            min_ranges_each_zone=tuple(czm.get(
                "min_ranges_each_zone", patchwork.min_ranges_each_zone)),
            elevation_thresholds=tuple(czm.get(
                "elevation_thresholds", patchwork.elevation_thresholds)),
            flatness_thresholds=tuple(czm.get(
                "flatness_thresholds", patchwork.flatness_thresholds)))
        if "min_r" in flat or "min_ranges_each_zone" in czm:
            # keep the reference invariant min_r == min_ranges[0]
            patchwork = dataclasses.replace(
                patchwork, min_r=patchwork.min_ranges_each_zone[0])

    projection = dataclasses.replace(cfg.projection,
                                     neighbor_mode=neighbor_mode)
    return dataclasses.replace(
        cfg, lidar=lidar, fpfh=fpfh, solver=solver, patchwork=patchwork,
        projection=projection, ground_segmentation_mode=ground_mode,
        voxel_size=voxel_size)
