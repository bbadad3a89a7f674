"""Build the host-side C++ helpers under `data/_native/` with g++.

`native_lmdb.py` and `native_loader.py` compile their source at first use
into `build/handsonvlm_torch/` at the repository root (never beside the
source), named by a hash of the source and the command, so an edited
source rebuilds and an unchanged one loads the existing file. The library
is written under a temporary name and renamed into place, so processes
that build at once never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

NATIVE_DIR = Path(__file__).resolve().parent / "_native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "handsonvlm_torch"


def build_native(source: str, flags: Sequence[str], libs: Sequence[str] = (),
                 timeout: int = 180) -> Optional[Path]:
    """Compile `_native/<source>` into a shared library; returns its path,
    or None (with the compiler's message printed) when g++ or a library it
    links is missing."""
    src = NATIVE_DIR / source
    cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17"]
    key = hashlib.sha256(src.read_bytes() + " ".join([*cmd, *libs]).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([*cmd, str(src), "-o", str(tmp), *libs], check=True,
                       capture_output=True, timeout=timeout)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        print(f"native build of {source} failed ({e}); "
              f"{getattr(e, 'stderr', b'') or b''!r:.300}")
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out
