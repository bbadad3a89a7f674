"""Native LMDB reader (ctypes over _native/lmdb_reader.cpp) + fixture writer.

Port of `handsonvlm_tpu/data/native_lmdb.py`. The reference's EPIC feature
store is an LMDB of pickled per-frame dicts
(hoi_forecast/dataset/epic_structures.py, lmdbdict). Where neither liblmdb
nor the python lmdb package is installed:

- `NativeLmdbDict`: read-only dict view over a data.mdb file — mmap + B+tree
  lookup implemented from the on-disk format in C++, compiled with g++ at
  first use into `build/handsonvlm_torch/` (data/native_build.py). Values
  are unpickled, matching the `_LmdbView` interface in
  data/epic_structures.py.
- `write_lmdb_fixture`: a minimal pure-python LMDB *writer* (single
  transaction, default comparator, overflow pages for big values) used to
  build test fixtures and synthetic feature DBs without liblmdb.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from handsonvlm_torch.data.native_build import build_native

_lock = threading.Lock()
_lib = None
_tried = False

PAGEHDRSZ = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_native("lmdb_reader.cpp", ["-O2"], timeout=120)
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.lmdb_open.restype = ctypes.c_void_p
        lib.lmdb_open.argtypes = [ctypes.c_char_p]
        lib.lmdb_close.argtypes = [ctypes.c_void_p]
        lib.lmdb_entries.restype = ctypes.c_int64
        lib.lmdb_entries.argtypes = [ctypes.c_void_p]
        lib.lmdb_get.restype = ctypes.c_int
        lib.lmdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.lmdb_cursor_open.restype = ctypes.c_void_p
        lib.lmdb_cursor_open.argtypes = [ctypes.c_void_p]
        lib.lmdb_cursor_next.restype = ctypes.c_int
        lib.lmdb_cursor_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.lmdb_cursor_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


class NativeLmdbDict:
    """Read-only dict view of an LMDB file: bytes keys -> unpickled values.

    Drop-in for the lmdbdict/_LmdbView interface used by EpicHOIDataset
    (`key in env`, `env[key]`)."""

    def __init__(self, path: str, unpickle: bool = True):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native lmdb reader unavailable (g++ build failed)")
        self._lib = lib
        self._h = lib.lmdb_open(os.fspath(path).encode())
        if not self._h:
            raise OSError(f"cannot open lmdb at {path}")
        self._unpickle = unpickle

    def _get_raw(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        rc = self._lib.lmdb_get(self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen))
        if rc == 0:
            return ctypes.string_at(val.value, vlen.value)
        if rc == -1:
            return None
        raise OSError(f"lmdb_get error {rc} for key {key!r}")

    def __contains__(self, key: bytes) -> bool:
        return self._get_raw(key) is not None

    def __getitem__(self, key: bytes):
        buf = self._get_raw(key)
        if buf is None:
            raise KeyError(key)
        return pickle.loads(buf) if self._unpickle else buf

    def get(self, key: bytes, default=None):
        buf = self._get_raw(key)
        if buf is None:
            return default
        return pickle.loads(buf) if self._unpickle else buf

    def __len__(self) -> int:
        return int(self._lib.lmdb_entries(self._h))

    def items(self) -> Iterator[Tuple[bytes, object]]:
        cur = self._lib.lmdb_cursor_open(self._h)
        if not cur:
            return
        try:
            key = ctypes.c_void_p()
            klen = ctypes.c_size_t()
            val = ctypes.c_void_p()
            vlen = ctypes.c_size_t()
            while True:
                rc = self._lib.lmdb_cursor_next(
                    cur, ctypes.byref(key), ctypes.byref(klen),
                    ctypes.byref(val), ctypes.byref(vlen),
                )
                if rc == -1:
                    return
                if rc != 0:
                    raise OSError(f"lmdb cursor error {rc}")
                k = ctypes.string_at(key.value, klen.value)
                v = ctypes.string_at(val.value, vlen.value)
                yield k, (pickle.loads(v) if self._unpickle else v)
        finally:
            self._lib.lmdb_cursor_close(cur)

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k

    def close(self):
        if self._h:
            self._lib.lmdb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ---------------------------------------------------------------------------
# Fixture writer: minimal single-transaction LMDB file (default comparator).
# Layout mirrors upstream mdb.c so both this repo's C++ reader and real
# liblmdb can read the output.
# ---------------------------------------------------------------------------


def _node_size(klen: int, dlen: int, bigdata: bool) -> int:
    sz = 8 + klen + (8 if bigdata else dlen)
    return (sz + 1) & ~1  # 2-byte alignment, as in mdb.c EVEN()


class _PageBuilder:
    def __init__(self, psize: int, pgno: int, flags: int):
        self.psize = psize
        self.pgno = pgno
        self.flags = flags
        self.nodes: List[bytes] = []
        self.used = PAGEHDRSZ

    def fits(self, node: bytes) -> bool:
        return self.used + 2 + len(node) + (len(node) & 1) <= self.psize

    def add(self, node: bytes) -> None:
        self.nodes.append(node)
        self.used += 2 + len(node) + (len(node) & 1)

    def render(self) -> bytes:
        ptrs, blobs = [], []
        upper = self.psize
        for n in self.nodes:
            upper -= len(n) + (len(n) & 1)
        off = upper
        for n in self.nodes:
            ptrs.append(off)
            blobs.append(n + (b"\0" if len(n) & 1 else b""))
            off += len(n) + (len(n) & 1)
        lower = PAGEHDRSZ + 2 * len(self.nodes)
        assert lower <= upper, "page overflow"
        hdr = struct.pack("<QHHHH", self.pgno, 0, self.flags, lower, upper)
        body = b"".join(struct.pack("<H", p) for p in ptrs)
        page = hdr + body
        page += b"\0" * (upper - len(page))
        page += b"".join(blobs)
        assert len(page) == self.psize
        return page


def write_lmdb_fixture(path: str, mapping: Dict[bytes, bytes], psize: int = 4096) -> str:
    """Write `mapping` (bytes->bytes, values NOT pickled here) as a valid
    data.mdb. Returns the file path. Values larger than ~1/2 page go to
    overflow pages (F_BIGDATA), keys must fit a node (< ~psize/2)."""
    if os.path.isdir(path):
        path = os.path.join(path, "data.mdb")
    items = sorted(mapping.items())
    pages: Dict[int, bytes] = {}
    next_pg = 2  # 0/1 are meta

    def alloc(n=1):
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    big_threshold = psize // 2 - 32
    overflow_pages = 0

    # ---- leaves -----------------------------------------------------------
    leaf_entries: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    leaf = None
    leaf_pgno = None

    def flush_leaf():
        nonlocal leaf, leaf_pgno
        if leaf is not None:
            pages[leaf_pgno] = leaf.render()
            leaf = None

    for k, v in items:
        big = len(v) > big_threshold
        if big:
            npages = -(-(PAGEHDRSZ + len(v)) // psize)
            opg = alloc(npages)
            ohdr = struct.pack("<QHHI", opg, 0, P_OVERFLOW, npages)
            blob = ohdr + v
            blob += b"\0" * (npages * psize - len(blob))
            for i in range(npages):
                pages[opg + i] = blob[i * psize:(i + 1) * psize]
            overflow_pages += npages
            node = struct.pack("<HHHH", len(v) & 0xFFFF, (len(v) >> 16) & 0xFFFF,
                               F_BIGDATA, len(k)) + k + struct.pack("<Q", opg)
        else:
            node = struct.pack("<HHHH", len(v) & 0xFFFF, (len(v) >> 16) & 0xFFFF,
                               0, len(k)) + k + v
        if leaf is None or not leaf.fits(node):
            flush_leaf()
            leaf_pgno = alloc()
            leaf = _PageBuilder(psize, leaf_pgno, P_LEAF)
            leaf_entries.append((k, leaf_pgno))
        leaf.add(node)
    flush_leaf()

    # ---- branches (bottom-up) ----------------------------------------------
    depth = 1
    level = leaf_entries
    branch_pages = 0
    while len(level) > 1:
        depth += 1
        nxt: List[Tuple[bytes, int]] = []
        br = None
        br_pgno = None

        def flush_branch():
            nonlocal br, br_pgno
            if br is not None:
                pages[br_pgno] = br.render()
                br = None

        for i, (first_key, child) in enumerate(level):
            is_first_in_page = br is None
            key = b"" if is_first_in_page else first_key
            node = struct.pack(
                "<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                (child >> 32) & 0xFFFF, len(key),
            ) + key
            if br is not None and not br.fits(node):
                flush_branch()
                key = b""  # new page: first node key is implicit
                node = struct.pack(
                    "<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                    (child >> 32) & 0xFFFF, 0,
                )
            if br is None:
                br_pgno = alloc()
                br = _PageBuilder(psize, br_pgno, P_BRANCH)
                branch_pages += 1
                nxt.append((first_key, br_pgno))
            br.add(node)
        flush_branch()
        level = nxt

    root = level[0][1] if level else 0xFFFFFFFFFFFFFFFF
    if not items:
        depth = 0

    # ---- metas --------------------------------------------------------------
    def meta_page(pgno: int, txnid: int) -> bytes:
        free_db = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0,
                              0xFFFFFFFFFFFFFFFF)
        main_db = struct.pack(
            "<IHHQQQQQ", 0, 0, depth,
            branch_pages, len({p for _, p in leaf_entries}), overflow_pages,
            len(items), root,
        )
        meta = struct.pack("<IIQQ", 0xBEEFC0DE, 1, 0, psize * max(next_pg, 4))
        meta += free_db + main_db
        meta += struct.pack("<QQ", next_pg - 1, txnid)
        hdr = struct.pack("<QHHHH", pgno, 0, P_META, 0, 0)
        page = hdr + meta
        return page + b"\0" * (psize - len(page))

    with open(path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for pg in range(2, next_pg):
            f.write(pages.get(pg, b"\0" * psize))
    return path


def write_lmdb_pickled(path: str, mapping: Dict[bytes, object], psize: int = 4096) -> str:
    """Convenience: pickle each value (the reference DB's value format)."""
    return write_lmdb_fixture(
        path, {k: pickle.dumps(v, protocol=4) for k, v in mapping.items()}, psize
    )
