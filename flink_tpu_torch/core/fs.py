"""FileSystem abstraction behind a scheme registry (port of
``flink_tpu/core/fs.py``).

Rebuilds the reference's FS SPI (flink-core/.../core/fs/
FileSystem.java — `FileSystem.get(uri)` resolves a scheme to a
registered implementation; local/HDFS/S3/... plug in behind it, and
flink-filesystems/ ships shaded plugins).  Here:

- `FileSystem` is the operation contract (the subset the framework's
  storage layers actually use: open/exists/makedirs/listdir/replace/
  remove/getmtime/utime);
- `LocalFileSystem` is the default (`/path` or `file://`);
- `MemoryFileSystem` (`mem://`) is the in-process implementation —
  both a test double and the proof of pluggability;
- `get_file_system(path) -> (fs, stripped_path)` resolves by scheme,
  and `register_file_system(scheme, fs)` adds new ones (an
  object-store plugin registers here exactly like the reference's
  `flink-s3-fs-*` plugins register their schemes).

Checkpoint storage (``runtime/checkpoints.FsCheckpointStorage``) routes
through this SPI, so `state.checkpoints.dir: mem://x/y` or a custom
scheme work without code changes."""

from __future__ import annotations

import abc
import io
import os
import threading
import time as _time
from typing import Dict, List, Tuple

from flink_tpu_torch.runtime import faults


class FileSystem(abc.ABC):
    @abc.abstractmethod
    def open(self, path: str, mode: str = "rb"): ...

    @abc.abstractmethod
    def exists(self, path: str) -> bool: ...

    @abc.abstractmethod
    def makedirs(self, path: str) -> None: ...

    @abc.abstractmethod
    def listdir(self, path: str) -> List[str]: ...

    @abc.abstractmethod
    def replace(self, src: str, dst: str) -> None:
        """Atomic rename (the rename-free-persistence contract)."""

    @abc.abstractmethod
    def remove(self, path: str) -> None: ...

    def getmtime(self, path: str) -> float:
        raise NotImplementedError

    def utime(self, path: str) -> None:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    """(ref: core/fs/local/LocalFileSystem.java)"""

    def open(self, path, mode="rb"):
        return open(path, mode)

    def exists(self, path):
        return os.path.exists(path)

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def listdir(self, path):
        return os.listdir(path)

    def replace(self, src, dst):
        # the durable-commit point of every storage write path — where
        # an injected "disk" failure is indistinguishable from a real
        # one to the layers above
        faults.fire("storage.persist")
        os.replace(src, dst)

    def remove(self, path):
        os.remove(path)

    def getmtime(self, path):
        return os.path.getmtime(path)

    def utime(self, path):
        os.utime(path)


class _MemFile(io.BytesIO):
    def __init__(self, store, path, lock, data=b""):
        super().__init__(data)
        self._store = store
        self._path = path
        self._lock = lock

    def close(self):
        if self.closed:
            return  # idempotent, like every other Python file object
        with self._lock:  # writers publish under the same lock every
            # other MemoryFileSystem operation holds
            self._store[self._path] = (self.getvalue(), _time.time())
        super().close()


class _MemTextFile(io.StringIO):
    def __init__(self, store, path, lock, text=""):
        super().__init__(text)
        self._store = store
        self._path = path
        self._lock = lock

    def close(self):
        if self.closed:
            return
        with self._lock:
            self._store[self._path] = (self.getvalue().encode(),
                                       _time.time())
        super().close()


class MemoryFileSystem(FileSystem):
    """In-process filesystem (`mem://`): a scheme-registered test
    double + the minimal model of an object store."""

    def __init__(self):
        self._files: Dict[str, Tuple[bytes, float]] = {}
        self._lock = threading.Lock()

    def open(self, path, mode="rb"):
        text = "b" not in mode
        with self._lock:
            if "r" in mode:
                if path not in self._files:
                    raise FileNotFoundError(path)
                data = self._files[path][0]
                return io.StringIO(data.decode()) if text \
                    else io.BytesIO(data)
            existing = (self._files.get(path, (b"", 0.0))[0]
                        if "a" in mode else b"")
        if text:
            return _MemTextFile(self._files, path, self._lock,
                                existing.decode())
        return _MemFile(self._files, path, self._lock, existing)

    def exists(self, path):
        with self._lock:
            return path in self._files or any(
                k.startswith(path.rstrip("/") + "/") for k in self._files)

    def makedirs(self, path):
        pass  # directories are implicit

    def listdir(self, path):
        prefix = path.rstrip("/") + "/"
        with self._lock:
            return sorted({k[len(prefix):].split("/", 1)[0]
                           for k in self._files if k.startswith(prefix)})

    def replace(self, src, dst):
        faults.fire("storage.persist")  # same commit point as local
        with self._lock:
            if src not in self._files:
                raise FileNotFoundError(src)
            self._files[dst] = self._files.pop(src)

    def remove(self, path):
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            del self._files[path]

    def getmtime(self, path):
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            return self._files[path][1]

    def utime(self, path):
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            data, _ = self._files[path]
            self._files[path] = (data, _time.time())


_LOCAL = LocalFileSystem()
_REGISTRY: Dict[str, FileSystem] = {
    "file": _LOCAL,
    "mem": MemoryFileSystem(),
}


def register_file_system(scheme: str, fs: FileSystem) -> None:
    """(ref: the FileSystemFactory plugin registration)"""
    _REGISTRY[scheme] = fs


def get_file_system(path: str) -> Tuple[FileSystem, str]:
    """Resolve `scheme://rest` to (fs, path-as-the-fs-sees-it);
    schemeless paths are local (ref: FileSystem.get(uri))."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        fs = _REGISTRY.get(scheme)
        if fs is None:
            raise ValueError(f"no filesystem registered for scheme "
                             f"{scheme!r} (have {sorted(_REGISTRY)})")
        if scheme == "file":
            return fs, "/" + rest.lstrip("/")
        return fs, path
    return _LOCAL, path
