"""Dataset file cache with download support (port of
``multimodalfilter_tpu/data/cache.py``).

A missing cache entry is synthesised (``MMF_TPU_SYNTHESIZE_DATA=1``, see
``data/synthetic.py``), fetched from its URL (plain http(s)/file:// or a
Google Drive share link; streamed to a temp file, optionally checksummed and
moved into place atomically), or reported with instructions.

``cached_trajectories`` reads a dataset's raw trajectories. Where ``h5py`` is
missing, ``MMF_TPU_SYNTHESIZE_DATA=1`` and no file is
cached, it synthesises them in memory and writes no file. The port keeps its
own cache path: it is not the JAX package's ``_cache_path``.
"""

from __future__ import annotations

import os
import re
import urllib.request
from typing import Dict, List, Optional

import numpy as np

from .trajectories_file import TrajectoriesFile, h5py_available

_cache_path: Optional[str] = None
# Trajectories held in memory, by the path their file would have.
_in_memory: Dict[str, List[Dict[str, np.ndarray]]] = {}

_DRIVE_FILE_RE = re.compile(r"drive\.google\.com/file/d/([\w-]+)")
_DRIVE_OPEN_RE = re.compile(r"drive\.google\.com/.*[?&]id=([\w-]+)")
_CHUNK = 1 << 20


def set_cache_path(path: str) -> None:
    global _cache_path
    _cache_path = path
    os.makedirs(path, exist_ok=True)


def get_cache_path() -> str:
    global _cache_path
    if _cache_path is None:
        set_cache_path(os.path.join(os.getcwd(), ".cache"))
    return _cache_path


def drive_direct_url(url: str) -> str:
    """Rewrite a Google Drive share link to its direct-download form
    (fannypack's cached_drive_file accepts share links the same way)."""
    m = _DRIVE_FILE_RE.search(url) or _DRIVE_OPEN_RE.search(url)
    if m:
        return f"https://drive.google.com/uc?export=download&id={m.group(1)}"
    return url


def _open_with_drive_confirm(url: str):
    """Open a URL, following Google Drive's large-file confirm-token
    interstitial (the HTML page with a confirm link) when served one."""
    import http.cookiejar
    import urllib.parse

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar)
    )
    resp = opener.open(url, timeout=60)
    content_type = resp.headers.get("Content-Type", "")
    if "text/html" not in content_type:
        return resp
    # Drive interstitial: find the confirm token in cookies or the page.
    token = None
    for cookie in jar:
        if cookie.name.startswith("download_warning"):
            token = cookie.value
            break
    if token is None:
        page = resp.read(1 << 20).decode("utf-8", errors="replace")
        m = re.search(r"confirm=([\w-]+)", page)
        if not m:
            raise OSError(
                f"Google Drive returned an HTML page without a confirm "
                f"token for {url!r} (quota exceeded or permission denied?)"
            )
        token = m.group(1)
    sep = "&" if "?" in url else "?"
    return opener.open(f"{url}{sep}confirm={urllib.parse.quote(token)}", timeout=60)


def download_file(url: str, dest_path: str, sha256: Optional[str] = None) -> str:
    """Stream `url` to `dest_path`: temp file + checksum + atomic rename, so
    a crashed/interrupted download never leaves a corrupt cache entry."""
    import hashlib

    url = drive_direct_url(url)
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    tmp_path = f"{dest_path}.tmp.{os.getpid()}"
    hasher = hashlib.sha256() if sha256 else None
    try:
        if "drive.google.com" in url:
            resp = _open_with_drive_confirm(url)
        else:
            resp = urllib.request.urlopen(url, timeout=60)
        with resp, open(tmp_path, "wb") as f:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                f.write(chunk)
                if hasher is not None:
                    hasher.update(chunk)
        if hasher is not None and hasher.hexdigest() != sha256:
            raise OSError(
                f"Checksum mismatch for {url!r}: got {hasher.hexdigest()}, "
                f"expected {sha256}"
            )
        os.replace(tmp_path, dest_path)  # atomic on POSIX
        return dest_path
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


def cached_file(name: str, url: str = "", sha256: Optional[str] = None) -> str:
    """Return the local path of a cached dataset file, downloading it from
    `url` on a cache miss.

    Resolution order on a miss:
      1. synthesize a stand-in with the same key schema when
         MMF_TPU_SYNTHESIZE_DATA=1 (checked first, so that runs without a
         network never wait on one);
      2. download from `url` (unless empty or MMF_TPU_OFFLINE=1);
      3. raise with instructions.
    """
    path = os.path.join(get_cache_path(), name)
    if os.path.exists(path):
        return path

    if _synthesize():
        from . import synthetic

        synthetic.synthesize_named_dataset(name, path)
        return path

    download_error: Optional[Exception] = None
    if url and os.environ.get("MMF_TPU_OFFLINE", "0") != "1":
        try:
            return download_file(url, path, sha256=sha256)
        except Exception as exc:  # fall through to raise with context
            download_error = exc

    raise FileNotFoundError(
        f"Dataset file {name!r} not found in cache ({path}); download from "
        f"{url!r} failed ({download_error!r}). Place the file there manually, "
        "or set MMF_TPU_SYNTHESIZE_DATA=1 to generate a synthetic stand-in."
    )


def _synthesize() -> bool:
    return os.environ.get("MMF_TPU_SYNTHESIZE_DATA", "0") == "1"


def keep_in_memory(name: str, trajectories: List[Dict[str, np.ndarray]]) -> None:
    """Hold `trajectories` as dataset `name` under the current cache path:
    ``cached_trajectories`` returns them ahead of any file. (How a caller
    fixes the seed of an in-memory synthetic set.)"""
    _in_memory[os.path.join(get_cache_path(), name)] = list(trajectories)


def cached_trajectories(name: str, url: str = "",
                        sha256: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
    """The raw trajectories of dataset file `name`, one dict of (T, ...)
    arrays each.

    Trajectories held in memory come first. Else, where no file is cached
    and ``h5py`` is missing, they are synthesised in memory with
    MMF_TPU_SYNTHESIZE_DATA=1 (once per cache path and name; no file is
    written), and without it this raises ``ImportError`` (nothing is
    downloaded that could not be read). Else the file is read from
    ``cached_file``; a cached file without ``h5py`` raises, so it is never
    replaced by data of another kind."""
    path = os.path.join(get_cache_path(), name)
    if path not in _in_memory and not os.path.exists(path) and not h5py_available():
        if not _synthesize():
            raise ImportError(
                f"dataset {name!r}: no file is cached at {path}, and h5py, which "
                "reads one, is not installed; set MMF_TPU_SYNTHESIZE_DATA=1 to "
                "synthesise it in memory"
            )
        from . import synthetic

        keep_in_memory(name, synthetic.named_trajectories(name))
    if path in _in_memory:
        # Fresh arrays, as a file read gives: the loader writes into them.
        return [{k: v.copy() for k, v in raw.items()} for raw in _in_memory[path]]
    with TrajectoriesFile(cached_file(name, url, sha256)) as f:
        return list(f)
