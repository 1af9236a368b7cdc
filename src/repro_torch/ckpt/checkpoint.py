"""Checkpoint/restart without a framework (the reference's
``repro.ckpt.checkpoint``): a flat-key ``.npz`` plus a JSON manifest,
written atomically (temporary file, then rename), and a manager that
keeps the last k checkpoints and saves on a background thread.

The file format is the reference's, key for key, so a checkpoint written
by either package loads in the other: each leaf is stored under
``jax.tree_util.keystr`` of its path (``['params']['layers']['mlp']
['gate']``, ``['opt'].step``, ``['opt'].mu['embed']``; ``tree``
writes these strings), a bfloat16 leaf as its uint16 view under the key
with ``::bf16`` appended.  With the step-indexed data pipeline a restored
run resumes bit for bit.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_path, tree_map, tree_unflatten


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def _flatten(tree) -> dict:
    out = {}
    for key, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            out[key + "::bf16"] = _host(leaf)
        else:
            out[key] = _host(leaf)
    return out


def save_checkpoint(path, tree, step: int, extra: Optional[dict] = None):
    """Write ``tree`` (tensors on any device) and a manifest beside it."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, str(path))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    manifest = {"step": int(step), "file": path.name, "extra": extra or {}}
    mpath = path.parent / (path.stem + ".json")
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, str(mpath))


def load_checkpoint(path, like) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf with ``like``'s type, on ``like``'s device."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    leaves = []
    for key, leaf in leaves_with_path(like):
        if key + "::bf16" in data:
            arr = torch.from_numpy(data[key + "::bf16"].view(np.int16)
                                   .copy()).view(torch.bfloat16)
        elif key in data:
            arr = torch.from_numpy(np.array(data[key], copy=True))
        else:
            raise KeyError(f"checkpoint missing {key}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= model shape {tuple(leaf.shape)}")
        if arr.dtype != leaf.dtype:
            raise TypeError(f"{key}: checkpoint dtype {arr.dtype} != model "
                            f"dtype {leaf.dtype}")
        leaves.append(arr.to(leaf.device))
    return tree_unflatten(like, leaves)


class CheckpointManager:
    """Rolling async checkpointing (keep-last-k)."""

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _prune(self):
        ckpts = sorted(self.dir.glob("step_*.npz"))
        for old in ckpts[:-self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)

    def save(self, tree, step: int, blocking: bool = False):
        # copy to the host before the thread starts: the next step writes
        # new device tensors while this one is being saved
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True)
                             if isinstance(t, torch.Tensor) else t, tree)
        path = self.dir / f"step_{step:08d}.npz"

        def work():
            save_checkpoint(path, host_tree, step)
            self._prune()

        self.wait()
        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest(self) -> Tuple[Optional[pathlib.Path], int]:
        self.wait()
        ckpts = sorted(self.dir.glob("step_*.json"))
        if not ckpts:
            return None, -1
        manifest = json.loads(ckpts[-1].read_text())
        return self.dir / manifest["file"], manifest["step"]

    def restore_latest(self, like):
        path, step = self.latest()
        if path is None:
            return None, -1
        return load_checkpoint(path, like), step
