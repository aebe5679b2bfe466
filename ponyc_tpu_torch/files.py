"""File system access with object-capability discipline — ≙
packages/files over lang/{paths,directory,stat}.c.

Pony's files package is *synchronous* (unlike net/process): File and
Directory do blocking FFI into lang/directory.c / lang/stat.c, guarded
by the object-capability chain AmbientAuth → FileAuth → FilePath, so a
library can only touch paths it was handed a capability for. This
port keeps both properties: synchronous host-side ops (file IO from a
host actor between steps is exactly how the reference's scheduler runs
file code on a scheduler thread) and the capability chain:

    root = rt.files_auth()              # ≙ env.root (AmbientAuth)
    fp   = FilePath(root, "/tmp/data")  # ≙ FilePath(FileAuth(root), ...)
    f    = File(fp)                     # create/read/write/seek
    sub  = fp.join("logs")              # capability narrows with the path

A FilePath derived by join() can never escape its parent's subtree
(".." is resolved then checked) — the reference's path-capability rule
(packages/files/file_path.pony).
"""

from __future__ import annotations

import os
import shutil
import stat as _stat
from typing import Iterator, List, Optional


class FilesAuth:
    """Root capability (≙ AmbientAuth/FileAuth). Obtained from the
    runtime so ambient authority is explicit."""

    _token = object()

    def __init__(self, token):
        if token is not FilesAuth._token:
            raise PermissionError(
                "obtain FilesAuth via rt.files_auth(), not directly")


def _auth() -> FilesAuth:
    return FilesAuth(FilesAuth._token)


class FilePath:
    """A capability to one path and everything beneath it
    (≙ packages/files/file_path.pony)."""

    def __init__(self, auth, path: str):
        if isinstance(auth, FilesAuth):
            self.path = os.path.realpath(path)
        elif isinstance(auth, FilePath):
            joined = os.path.realpath(
                os.path.join(auth.path, path))
            if not (joined == auth.path
                    or joined.startswith(auth.path + os.sep)):
                raise PermissionError(
                    f"{path!r} escapes the {auth.path!r} capability")
            self.path = joined
        else:
            raise PermissionError(
                "FilePath needs a FilesAuth or parent FilePath capability")

    def join(self, rel: str) -> "FilePath":
        return FilePath(self, rel)

    # -- queries (≙ FileInfo / lang/stat.c) --
    def exists(self) -> bool:
        return os.path.exists(self.path)

    def info(self) -> Optional[os.stat_result]:
        try:
            return os.stat(self.path)
        except OSError:
            return None

    def is_file(self) -> bool:
        st = self.info()
        return st is not None and _stat.S_ISREG(st.st_mode)

    def is_dir(self) -> bool:
        st = self.info()
        return st is not None and _stat.S_ISDIR(st.st_mode)

    # -- mutations (≙ FilePath.mkdir/remove/rename + directory.c) --
    def mkdir(self, recursive: bool = True) -> bool:
        try:
            if recursive:
                os.makedirs(self.path, exist_ok=True)
            else:
                os.mkdir(self.path)
            return True
        except OSError:
            return False

    def remove(self) -> bool:
        """File or directory tree (≙ FilePath.remove)."""
        try:
            if self.is_dir():
                shutil.rmtree(self.path)
            else:
                os.remove(self.path)
            return True
        except OSError:
            return False

    def rename(self, to: "FilePath") -> bool:
        if not isinstance(to, FilePath):
            raise PermissionError("rename target must be a FilePath")
        try:
            os.rename(self.path, to.path)
            return True
        except OSError:
            return False


class File:
    """Buffered read/write file (≙ packages/files/file.pony)."""

    def __init__(self, fp: FilePath, mode: str = "a+b"):
        if not isinstance(fp, FilePath):
            raise PermissionError("File needs a FilePath capability")
        self.fp = fp
        self._f = open(fp.path, mode)

    def write(self, data) -> "File":
        self._f.write(data if isinstance(data, bytes) else
                      str(data).encode())
        return self

    def print(self, line) -> "File":
        return self.write(str(line).encode() + b"\n")

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)

    def lines(self) -> List[bytes]:
        self.seek_start()
        return self._f.read().split(b"\n")

    def seek_start(self, offset: int = 0) -> "File":
        self._f.seek(offset, os.SEEK_SET)
        return self

    def seek_end(self, offset: int = 0) -> "File":
        self._f.seek(-offset if offset else 0, os.SEEK_END)
        return self

    def position(self) -> int:
        return self._f.tell()

    def size(self) -> int:
        pos = self._f.tell()
        self._f.seek(0, os.SEEK_END)
        n = self._f.tell()
        self._f.seek(pos, os.SEEK_SET)
        return n

    def flush(self) -> "File":
        self._f.flush()
        return self

    def dispose(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()


class Directory:
    """Directory listing/walking (≙ packages/files/directory.pony over
    lang/directory.c)."""

    def __init__(self, fp: FilePath):
        if not isinstance(fp, FilePath):
            raise PermissionError("Directory needs a FilePath capability")
        if not fp.is_dir():
            raise NotADirectoryError(fp.path)
        self.fp = fp

    def entries(self) -> List[str]:
        return sorted(os.listdir(self.fp.path))

    def walk(self) -> Iterator:
        """(dirpath: FilePath, dirnames, filenames) ≙ FilePath.walk."""
        for root, dirs, fnames in os.walk(self.fp.path):
            rel = os.path.relpath(root, self.fp.path)
            fp = self.fp if rel == "." else self.fp.join(rel)
            yield fp, sorted(dirs), sorted(fnames)

    def open_file(self, name: str, mode: str = "a+b") -> File:
        return File(self.fp.join(name), mode)

    def mkdir(self, name: str) -> "Directory":
        sub = self.fp.join(name)
        sub.mkdir()
        return Directory(sub)
