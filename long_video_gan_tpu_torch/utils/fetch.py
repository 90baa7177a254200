"""Cached URL fetching: download with retries into a URL-keyed cache and return
the local path.

The port's copy of `long_video_gan_tpu/utils/fetch.py`, with a cache of its
own (`$LVG_CACHE_DIR/long_video_gan_tpu_torch/downloads`, else under
`~/.cache`), apart from the JAX package's. `generate` resolves its `--lres`
and `--sres` checkpoints through `resolve_path`, so a `file://` URL or an
http(s) URL already in the cache works where a local path does. Without a
network a remote fetch fails with a clear error after its retries.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional


def default_cache_dir() -> str:
    return os.path.join(os.environ.get("LVG_CACHE_DIR", os.path.expanduser("~/.cache")),
                        "long_video_gan_tpu_torch", "downloads")


def is_url(spec: str) -> bool:
    return spec.startswith(("http://", "https://", "file://"))


def fetch_url(url: str, cache_dir: Optional[str] = None, num_attempts: int = 5,
              verbose: bool = True) -> str:
    """Return a local path for `url`, downloading into the cache on a miss.

    The cache key is md5(url) and the URL's basename. Writes are atomic (a
    temporary file, then `os.replace`), so concurrent callers are safe.
    """
    if not is_url(url):
        raise ValueError(f"not a URL: {url!r}")
    cache_dir = cache_dir or default_cache_dir()
    key = hashlib.md5(url.encode("utf-8")).hexdigest()
    name = os.path.basename(urllib.parse.urlparse(url).path) or "download"
    dest = os.path.join(cache_dir, f"{key}-{name}")
    if os.path.isfile(dest):
        return dest

    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{dest}.tmp.{os.getpid()}"
    last_err: Optional[Exception] = None
    for attempt in range(num_attempts):
        try:
            if verbose:
                print(f"Downloading {url} (attempt {attempt + 1}/{num_attempts}) ...")
            with urllib.request.urlopen(url, timeout=60) as resp, open(tmp, "wb") as fp:
                shutil.copyfileobj(resp, fp, length=1 << 20)
            os.replace(tmp, dest)
            return dest
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            last_err = e
            if os.path.exists(tmp):
                os.remove(tmp)
            if attempt + 1 < num_attempts:
                time.sleep(min(2.0 ** attempt, 30.0))
    raise RuntimeError(
        f"failed to fetch {url} after {num_attempts} attempts "
        f"(offline environment? pass a local path instead): {last_err}")


def resolve_path(spec: str, cache_dir: Optional[str] = None) -> str:
    """A local path as given; a URL through the cache."""
    return fetch_url(spec, cache_dir) if is_url(spec) else spec
