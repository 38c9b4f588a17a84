"""The port's host library behind ctypes (own copy of
``predictionio_tpu/utils/native.py``).

``ops/csrc/pio_scan.cpp`` holds three host routines that the train paths
call: the stable COO group-by of ALS (``coo_group``), the dense-row
cooccurrence top-N of similar-product (``cooccur_topn``) and the columnar
scan of a JSONL event file (``scan_jsonl_columnar``). ``ops/_build.py``
compiles it with g++ on first use into ``build/native/``. Unlike the JAX
loader this one has no python fallback: a missing compiler, a failed build
or an error code raises. The callers take their python formulation only
where the JAX package does for a reason other than failure: a cooccurrence
matrix past 2^28 cells (``cooccur_topn`` returns None) and the jsonl
filters the scan cannot express (``JSONLPEvents.to_columnar``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from predictionio_tpu_torch.ops import _build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# calls into the library by routine, for a caller that shows which path ran
calls = {"coo_group": 0, "cooccur_topn": 0, "scan_jsonl_columnar": 0}

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)

# pio_cooccur_topn's return codes
_COOCCUR_TOO_LARGE = 2  # n_items^2 past 2^28 cells: the scipy path serves it
_COOCCUR_ERRORS = {1: "n_items and top_n must be positive", 3: "out of memory",
                   4: "an item id outside [0, n_items)"}


def get_library() -> ctypes.CDLL:
    """The loaded library with every function's ctypes signature declared;
    built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load_host("pio_scan")
        lib.pio_scan_file.restype = ctypes.c_void_p
        lib.pio_scan_file.argtypes = [ctypes.c_char_p] * 5
        lib.pio_scan_num_rows.restype = ctypes.c_int64
        lib.pio_scan_num_rows.argtypes = [ctypes.c_void_p]
        lib.pio_scan_error.restype = ctypes.c_char_p
        lib.pio_scan_error.argtypes = [ctypes.c_void_p]
        lib.pio_scan_copy_int32.restype = None
        lib.pio_scan_copy_int32.argtypes = [ctypes.c_void_p, ctypes.c_int, _I32P]
        lib.pio_scan_copy_f64.restype = None
        lib.pio_scan_copy_f64.argtypes = [ctypes.c_void_p, _F64P]
        lib.pio_scan_copy_f32.restype = None
        lib.pio_scan_copy_f32.argtypes = [ctypes.c_void_p, _F32P]
        lib.pio_scan_vocab_size.restype = ctypes.c_int64
        lib.pio_scan_vocab_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pio_scan_vocab_get.restype = ctypes.c_char_p
        lib.pio_scan_vocab_get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
        lib.pio_scan_row_id.restype = ctypes.c_char_p
        lib.pio_scan_row_id.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pio_scan_ids_total_bytes.restype = ctypes.c_int64
        lib.pio_scan_ids_total_bytes.argtypes = [ctypes.c_void_p]
        lib.pio_scan_copy_ids.restype = None
        lib.pio_scan_copy_ids.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_char_p]
        lib.pio_scan_free.restype = None
        lib.pio_scan_free.argtypes = [ctypes.c_void_p]
        lib.pio_coo_group.restype = ctypes.c_int32
        lib.pio_coo_group.argtypes = [
            _I32P, _I32P, _F32P, ctypes.c_int64, ctypes.c_int32, _I32P, _F32P, _I32P,
        ]
        lib.pio_cooccur_topn.restype = ctypes.c_int32
        lib.pio_cooccur_topn.argtypes = [
            _I32P, _I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _I32P, _I32P,
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _library_for(routine: str) -> ctypes.CDLL:
    lib = get_library()
    with _lock:
        calls[routine] += 1
    return lib


def cooccur_topn(
    users: np.ndarray, items: np.ndarray, n_items: int, top_n: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Dense-row cooccurrence count + top-N select. ``users`` must be sorted
    ascending with DISTINCT (user, item) pairs (the shape ``np.unique``
    over 1-D codes produces). Returns ``(items, counts)`` matrices of shape
    (n_items, top_n), item slots padded with -1, ordered by count
    descending then item ascending; None when the dense count matrix would
    pass 2^28 cells (more than 16,384 items), for the scipy path. Any other
    refusal raises."""
    users = np.ascontiguousarray(users, np.int32)
    items = np.ascontiguousarray(items, np.int32)
    if users.shape != items.shape or users.ndim != 1:
        raise ValueError(f"users {users.shape} and items {items.shape} must be equal 1-D")
    out_items = np.empty((max(n_items, 0), max(top_n, 0)), np.int32)
    out_counts = np.empty_like(out_items)
    rc = _library_for("cooccur_topn").pio_cooccur_topn(
        _ptr(users, _I32P), _ptr(items, _I32P), users.shape[0], n_items, top_n,
        _ptr(out_items, _I32P), _ptr(out_counts, _I32P),
    )
    if rc == _COOCCUR_TOO_LARGE:
        return None
    if rc == 3:
        raise MemoryError(f"pio_cooccur_topn: {_COOCCUR_ERRORS[3]} ({n_items} items)")
    if rc != 0:
        raise ValueError(f"pio_cooccur_topn returned {rc}: {_COOCCUR_ERRORS.get(rc, 'unknown code')}")
    return out_items, out_counts


def coo_group(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_entities: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable group-by-entity of a COO rating list (a counting sort):
    ``(cols_sorted, vals_sorted, deg)``, rows grouped by ascending entity
    id with their original order kept within an entity, and ``deg`` the
    per-entity rating count. Every row id must lie in [0, n_entities)."""
    rows, cols, vals = (np.ascontiguousarray(a) for a in (rows, cols, vals))
    if rows.ndim != 1 or cols.shape != rows.shape or vals.shape != rows.shape:
        raise ValueError(
            f"rows {rows.shape}, cols {cols.shape} and vals {vals.shape} must be equal 1-D"
        )
    n = rows.shape[0]
    # checked before the int32 cast, which would wrap a wider id into range
    if n and (int(rows.min()) < 0 or int(rows.max()) >= n_entities):
        bad = int(rows.min()) if int(rows.min()) < 0 else int(rows.max())
        raise ValueError(f"entity index {bad} out of range for {n_entities} entities")
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    cols_out = np.empty(n, np.int32)
    vals_out = np.empty(n, np.float32)
    deg = np.zeros(n_entities, np.int32)
    rc = _library_for("coo_group").pio_coo_group(
        _ptr(rows, _I32P), _ptr(cols, _I32P), _ptr(vals, _F32P), n, n_entities,
        _ptr(cols_out, _I32P), _ptr(vals_out, _F32P), _ptr(deg, _I32P),
    )
    if rc != 0:
        raise ValueError(f"pio_coo_group returned {rc}")
    return cols_out, vals_out, deg


def scan_jsonl_columnar(
    path: str,
    event_names: list[str] | None = None,
    rating_key: str = "rating",
    entity_type: str | None = None,
    target_entity_type: str | None = None,
) -> dict:
    """Columnar scan of a JSONL event file: a dict of numpy columns, the
    three vocabularies in first-use order and the per-row event ids. Later
    lines win on a repeated event id; rows come out stably sorted by event
    time; a last line without its newline is not read."""
    lib = _library_for("scan_jsonl_columnar")
    csv = ",".join(event_names) if event_names else ""
    handle = lib.pio_scan_file(
        path.encode(), csv.encode(), rating_key.encode(),
        (entity_type or "").encode(), (target_entity_type or "").encode(),
    )
    try:
        err = lib.pio_scan_error(handle)
        if err:
            raise OSError(f"pio_scan_file {path}: {err.decode()}")
        n = lib.pio_scan_num_rows(handle)
        cols = {
            "entity_ids": np.empty(n, np.int32),
            "target_ids": np.empty(n, np.int32),
            "event_codes": np.empty(n, np.int32),
            "timestamps": np.empty(n, np.float64),
            "ratings": np.empty(n, np.float32),
        }
        event_ids: list[str] = []
        if n:
            for which, key in enumerate(("entity_ids", "target_ids", "event_codes")):
                lib.pio_scan_copy_int32(handle, which, _ptr(cols[key], _I32P))
            lib.pio_scan_copy_f64(handle, _ptr(cols["timestamps"], _F64P))
            lib.pio_scan_copy_f32(handle, _ptr(cols["ratings"], _F32P))
            # row ids in two calls (lengths, then one concatenated buffer):
            # one call and decode a row is a python loop as long as the scan
            lengths = np.empty(n, np.int32)
            buf = ctypes.create_string_buffer(max(1, int(lib.pio_scan_ids_total_bytes(handle))))
            lib.pio_scan_copy_ids(handle, _ptr(lengths, _I32P), buf)
            raw, pos = buf.raw, 0
            for ln in lengths.tolist():
                event_ids.append(raw[pos : pos + ln].decode())
                pos += ln

        def vocab(which: int) -> list[str]:
            return [lib.pio_scan_vocab_get(handle, which, i).decode()
                    for i in range(lib.pio_scan_vocab_size(handle, which))]

        return {**cols, "entity_vocab": vocab(0), "target_vocab": vocab(1),
                "event_vocab": vocab(2), "event_ids": event_ids}
    finally:
        lib.pio_scan_free(handle)
