"""Packed datasets (the port's own copy of
``cfdbench_tpu/data/datasets.py``): frame pairs for the autoregressive
models (``AutoDataset``), frames for the non-autoregressive ones
(``FrameDataset``).

Dense host arrays instead of the reference's per-pair tensor lists, with
the reference's semantics: pair slicing, convergence truncation, NaN
checks and case-param vectorization (``src/dataset/cavity.py:274-331``).
Each split's ``u.npy``/``v.npy`` are read in chunks of
:data:`PREFETCH_CHUNK` cases by the native reader (``data/fast_io.py``),
chunk k+1 while chunk k packs (:class:`_ChunkPrefetcher`), as the JAX
package reads them.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .core import DATA_DELTA_TIME, load_case, normalize_case_params
from .fast_io import clear_cache, prefetch_case_uv

# Cases read ahead in one native batch: peak residency stays at about two
# chunks of raw case arrays while the reader's thread pool has work.
PREFETCH_CHUNK = 64


class _ChunkPrefetcher:
    """Chunks of ``case_dirs`` read ahead on a worker thread: while chunk k
    packs, chunk k+1's ``u.npy``/``v.npy`` are read through the native
    pool (the ctypes call and numpy's packing release the GIL, so the two
    overlap). At most two chunks of raw arrays are held at a time."""

    def __init__(self, case_dirs: Sequence, chunk: Optional[int] = None):
        self._dirs = list(case_dirs)
        self._chunk = PREFETCH_CHUNK if chunk is None else chunk
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending = {}  # chunk index -> Future
        if self._dirs:
            self._submit(0)

    def _submit(self, k: int) -> None:
        lo = k * self._chunk
        if lo < len(self._dirs):
            self._pending[k] = self._pool.submit(prefetch_case_uv,
                                                 self._dirs[lo:lo + self._chunk])

    def ensure(self, case_id: int) -> None:
        """Call once a case, before loading it: at a chunk's first case, wait
        for that chunk's read (raising what it raised) and start the next
        chunk's."""
        if case_id % self._chunk:
            return
        k = case_id // self._chunk
        self._submit(k + 1)
        fut = self._pending.pop(k, None)
        if fut is not None:
            fut.result()

    def close(self) -> None:
        """Cancel the reads not started, wait for the one in flight, and drop
        what was read and not consumed: a build that fails mid-pack leaves
        no raw case arrays in the process's cache."""
        for fut in self._pending.values():
            fut.cancel()
        self._pool.shutdown(wait=True)
        clear_cache()


@dataclass
class AutoDataset:
    """Frame-pair dataset for autoregressive models.

    Arrays:
        inputs:  (N, H, W, 2)  — [u, v] at t
        labels:  (N, H, W, 2)  — [u, v] at t + delta_time
        masks:   (N, H, W, 1)  — geometry mask (1 interior, 0 obstacle)
        case_params: (N, P)    — per-pair case-parameter vector
        case_ids: (N,) int32   — originating case index

    Per-case data for multi-step rollout evaluation:
        all_features: list of (T, H, W, 3) arrays
        case_params_list: list of dicts (normalized)
    """

    inputs: np.ndarray
    labels: np.ndarray
    masks: np.ndarray
    case_params: np.ndarray
    case_ids: np.ndarray
    all_features: List[np.ndarray]
    case_params_list: List[Dict[str, float]]

    def __len__(self) -> int:
        return self.inputs.shape[0]

    @property
    def field_shape(self):
        return self.inputs.shape[1:3]

    @property
    def n_case_params(self) -> int:
        return self.case_params.shape[1]


@dataclass
class FrameDataset:
    """Frame-indexed dataset for non-autoregressive models: each example
    is (case_params, t, frame), t the frame's index within its case
    (``CavityFlowDataset.__getitem__``, ``cavity.py:199-205``)."""

    frames: np.ndarray        # (N, H, W, 3)
    frame_t: np.ndarray       # (N,) float32, frame index within its case
    case_params: np.ndarray   # (N, P), in FRAME_PARAM_KEYS order
    case_ids: np.ndarray      # (N,) int32
    case_params_list: List[Dict[str, float]]

    def __len__(self) -> int:
        return self.frames.shape[0]

    @property
    def field_shape(self):
        return self.frames.shape[1:3]

    @property
    def n_case_params(self) -> int:
        return self.case_params.shape[1]

    @property
    def num_points(self) -> int:
        """Pointwise examples in all (``sample_point_by_point``'s length,
        ``src/dataset/cavity.py:207-209``)."""
        h, w = self.field_shape
        return len(self) * h * w

    def point_examples(self, idxs: np.ndarray):
        """Vectorised ``sample_point_by_point`` (``cavity.py:180-196``):
        global point index → (case_params, query (t, x, y), u value).
        ``idx // (h·w)`` is the frame and the rest is row-major within it:
        y = pix // w is the ROW, x = pix % w the COLUMN (the reference's
        convention; x is the fast axis)."""
        h, w = self.field_shape
        num_pixels = h * w
        frame_idx = idxs // num_pixels
        pix = idxs % num_pixels
        y = pix // w
        x = pix % w
        query = np.stack(
            [self.frame_t[frame_idx], x.astype(np.float32), y.astype(np.float32)],
            axis=-1,
        )
        values = self.frames[frame_idx, y, x, 0]
        return self.case_params[frame_idx], query, values


# Problems whose auto datasets truncate at convergence. dam loads all
# frames (src/dataset/dam.py:304-312 has no stable-state cutoff).
_TRUNCATING = {"cavity", "tube", "cylinder"}


def _truncate_at_convergence(
    features: np.ndarray, time_step_size: int, stable_state_diff: float
) -> int:
    """Number of usable (input, label) pairs before convergence.

    Mirrors the loop in cavity.py:308-323: pairs are scanned in order and
    the first pair with mean |‖uv_t‖ − ‖uv_{t+Δ}‖| < ``stable_state_diff``
    terminates loading (that pair excluded).
    """
    inputs = features[:-time_step_size]
    outputs = features[time_step_size:]
    inp_mag = np.sqrt(inputs[..., 0] ** 2 + inputs[..., 1] ** 2)
    out_mag = np.sqrt(outputs[..., 0] ** 2 + outputs[..., 1] ** 2)
    diffs = np.abs(inp_mag - out_mag).mean(axis=(1, 2))
    converged = np.nonzero(diffs < stable_state_diff)[0]
    return int(converged[0]) if converged.size else len(inputs)


def _cache_file(cache_dir, problem, case_dirs, norm_props, norm_bc,
                delta_time, stable_state_diff) -> Path:
    """The npz cache's path, keyed by the full preprocessing config and
    each case dir's newest mtime, so a stale cache is never served. The
    key is the JAX package's, so both packages share one cache."""

    def sig(d):
        d = Path(d)
        try:
            mt = max(
                (p.stat().st_mtime_ns for p in d.iterdir()),
                default=d.stat().st_mtime_ns,
            )
        except OSError:
            mt = 0
        return (str(d), mt)

    key = hashlib.sha1(repr((
        problem, [sig(d) for d in case_dirs], norm_props, norm_bc,
        delta_time, stable_state_diff,
    )).encode()).hexdigest()[:16]
    return Path(cache_dir) / f"{problem}-{key}.npz"


def _load_cache(cache_file: Path) -> Optional[AutoDataset]:
    """The cached dataset, or None when the file is missing or unreadable
    (a truncated or corrupt cache is a miss, not a failure)."""
    if not cache_file.exists():
        return None
    try:
        with np.load(cache_file, allow_pickle=True) as z:
            n_cases = int(z["n_cases"])
            return AutoDataset(
                inputs=z["inputs"],
                labels=z["labels"],
                masks=z["masks"],
                case_params=z["case_params"],
                case_ids=z["case_ids"],
                all_features=[z[f"features_{i}"] for i in range(n_cases)],
                case_params_list=list(z["case_params_list"]),
            )
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile) as e:
        print(f"[data] cache {cache_file} unreadable "
              f"({type(e).__name__}: {e}); rebuilding")
        return None


def _save_cache(ds: AutoDataset, cache_file: Path) -> None:
    """Write through a temp file and an atomic rename: a killed writer
    never leaves a truncated npz under the final name, and concurrent
    writers of the same key race safely."""
    cache_file.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache_file.with_name(f".{cache_file.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                inputs=ds.inputs,
                labels=ds.labels,
                masks=ds.masks,
                case_params=ds.case_params,
                case_ids=ds.case_ids,
                n_cases=len(ds.all_features),
                case_params_list=np.asarray(ds.case_params_list, dtype=object),
                **{f"features_{i}": f for i, f in enumerate(ds.all_features)},
            )
        os.replace(tmp, cache_file)
    finally:
        if tmp.exists():  # failed before the rename
            tmp.unlink()


def build_auto_dataset(
    problem: str,
    case_dirs: Sequence[Path],
    norm_props: bool,
    norm_bc: bool,
    delta_time: float = 0.1,
    stable_state_diff: float = 0.001,
    cache_dir: Optional[Path] = None,
) -> AutoDataset:
    """``cache_dir``: optional directory for a preprocessed-array cache
    (npz), for every problem (the reference caches cylinder only,
    ``src/dataset/cylinder.py:477-541``)."""
    if cache_dir is not None:
        cache_file = _cache_file(cache_dir, problem, case_dirs, norm_props,
                                 norm_bc, delta_time, stable_state_diff)
        ds = _load_cache(cache_file)
        if ds is None:
            ds = build_auto_dataset(
                problem, case_dirs, norm_props, norm_bc,
                delta_time=delta_time, stable_state_diff=stable_state_diff,
            )
            _save_cache(ds, cache_file)
        return ds

    if len(case_dirs) == 0:
        raise ValueError(
            f"{problem}: split has 0 cases — too few cases for an 80/10/10 "
            "case-level split; add cases or merge subsets"
        )
    data_dt = DATA_DELTA_TIME[problem]
    time_step_size = int(delta_time / data_dt)
    if time_step_size < 1:
        raise ValueError(f"delta_time {delta_time} < data delta {data_dt}")
    prefetcher = _ChunkPrefetcher(case_dirs)
    try:
        return _build_auto_arrays(problem, case_dirs, prefetcher, time_step_size,
                                  stable_state_diff, norm_props, norm_bc)
    finally:
        prefetcher.close()


def _build_auto_arrays(problem, case_dirs, prefetcher, time_step_size,
                       stable_state_diff, norm_props, norm_bc):
    all_inputs, all_labels, all_masks = [], [], []
    all_params, all_case_ids = [], []
    all_features = []
    params_list = []
    for case_id, case_dir in enumerate(case_dirs):
        prefetcher.ensure(case_id)
        case = load_case(problem, Path(case_dir))
        features = case.features  # (T, H, W, 3)
        all_features.append(features)
        normalize_case_params(problem, case.params, norm_props, norm_bc)
        params_list.append(case.params)
        pvec = case.params_vector

        if features.shape[0] <= time_step_size:
            continue
        if problem in _TRUNCATING:
            n_pairs = _truncate_at_convergence(
                features, time_step_size, stable_state_diff
            )
        else:
            n_pairs = features.shape[0] - time_step_size
        if n_pairs == 0:
            continue
        inp = features[:n_pairs]
        out = features[time_step_size: time_step_size + n_pairs]
        if np.isnan(inp).any() or np.isnan(out).any():
            raise ValueError(f"NaN in case {case_dir}")
        all_inputs.append(inp[..., :2])
        all_labels.append(out[..., :2])
        all_masks.append(inp[..., 2:3])
        all_params.append(np.broadcast_to(pvec, (n_pairs, pvec.size)))
        all_case_ids.append(np.full((n_pairs,), case_id, dtype=np.int32))

    if not all_inputs:
        raise ValueError(f"{problem}: no training pairs produced")
    return AutoDataset(
        inputs=np.concatenate(all_inputs).astype(np.float32),
        labels=np.concatenate(all_labels).astype(np.float32),
        masks=np.concatenate(all_masks).astype(np.float32),
        case_params=np.concatenate(all_params).astype(np.float32),
        case_ids=np.concatenate(all_case_ids),
        all_features=all_features,
        case_params_list=params_list,
    )


# Per-problem case-param key order of the frame datasets (the reference
# classes' ``case_params_keys``, e.g. ``cavity.py:68-74``).
FRAME_PARAM_KEYS = {
    "cavity": ["vel_top", "density", "viscosity", "height", "width"],
    "tube": ["vel_in", "density", "viscosity", "height", "width"],
    "dam": ["velocity", "density", "viscosity", "height", "width"],
    "cylinder": [
        "vel_in", "density", "viscosity", "height", "width",
        "center_x", "center_y", "radius",
    ],
}


def build_frame_dataset(
    problem: str,
    case_dirs: Sequence[Path],
    norm_props: bool,
    norm_bc: bool,
) -> FrameDataset:
    if len(case_dirs) == 0:
        raise ValueError(
            f"{problem}: split has 0 cases — too few cases for an 80/10/10 "
            "case-level split; add cases or merge subsets"
        )
    keys = FRAME_PARAM_KEYS[problem]
    frames, frame_t, params_rows, case_ids = [], [], [], []
    params_list: List[Dict[str, float]] = []
    prefetcher = _ChunkPrefetcher(case_dirs)
    try:
        for case_id, case_dir in enumerate(case_dirs):
            prefetcher.ensure(case_id)
            case = load_case(problem, Path(case_dir))
            normalize_case_params(problem, case.params, norm_props, norm_bc)
            params_list.append(case.params)
            pvec = np.asarray([case.params[k] for k in keys], dtype=np.float32)
            T = case.num_frames
            frames.append(case.features)
            frame_t.append(np.arange(T, dtype=np.float32))
            params_rows.append(np.broadcast_to(pvec, (T, pvec.size)))
            case_ids.append(np.full((T,), case_id, dtype=np.int32))
    finally:
        prefetcher.close()
    return FrameDataset(
        frames=np.concatenate(frames).astype(np.float32),
        frame_t=np.concatenate(frame_t),
        case_params=np.concatenate(params_rows).astype(np.float32),
        case_ids=np.concatenate(case_ids),
        case_params_list=params_list,
    )
