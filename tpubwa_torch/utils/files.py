"""Files that several processes build or read at once.

A cache or build product that one process writes while another may load it
(the LUT cache that the command line's --multihost processes share, the
bench world's index, a kernel library) is written whole or not at all: the
writer fills a temporary file in the target's directory and renames it
over the target, which POSIX makes atomic within one file system. A reader
sees the old file, no file, or the new file, never a part of one; a writer
that fails leaves the target as it was and removes its temporary file (one
that is killed leaves the target as it was too).
"""
from __future__ import annotations

import os
import stat
import tempfile
from pathlib import Path


def write_atomic(path, write, suffix: str | None = None) -> Path:
    """Make ``path`` by ``write(tmp)`` on a temporary name beside it, then
    rename it into place, readable by all (a temporary file is made
    readable by its owner only). The temporary name ends with
    ``suffix`` (default: path's own), for writers that append one to a
    name without it, as ``np.savez`` does. On any exception the temporary
    file is removed and ``path`` is left untouched. Returns ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=path.suffix if suffix is None
                               else suffix, dir=path.parent)
    os.close(fd)
    try:
        write(tmp)
        os.chmod(tmp, stat.S_IMODE(os.stat(tmp).st_mode) | 0o444)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
