"""Fault-tolerant checkpointing (the JAX package's ``train/checkpoint.py``),
in its on-disk layout, so that each package restores the other's
checkpoints.

Layout: ``<dir>/step_%010d/`` holding ``arrays.npz`` (one array a key) and
``manifest.json`` (step, sorted keys, shapes, dtypes, a sha256 over the
sorted keys and their bytes, ``extra``). Writes go to ``<final>.tmp``, are
fsync'd and renamed, so a crashed writer never corrupts the latest
checkpoint; ``CheckpointManager`` adds retention and an async writer.

Keys are the reference's ``jax.tree_util`` paths joined by ``/``: a tuple
position is its index, a NamedTuple field ``.<field>``, a dict key itself.
A port model (``LM``) and a ``{parameter name: tensor}`` dict (the
optimizer's ``mu``, ``nu``, ``master``) flatten as the reference's nested
parameter dict, the layers restacked (``layers.3.attn.wq`` is row 3 of
``layers/attn/wq``). So ``(params, opt_state)`` gives ``0/embed/table``,
``0/layers/attn/wq`` [L, ...], ``1/.master/...``, ``1/.mu/...``,
``1/.nu/...`` and ``1/.step``, as the reference's ``(params, opt_state)``
does. bf16 leaves are widened to f32 on save (npz has no bf16) and restored
in the target's dtype.

Restore is in place: ``load_checkpoint`` copies each array into the tensor
(or numpy array) of ``tree_like`` that it belongs to and returns
``tree_like``, where the reference builds a new tree.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.convert import stack_index, stack_rows

_MANIFEST = "manifest.json"
_DATA = "arrays.npz"

Slots = Dict[str, List[Tuple[tuple, Any]]]


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _slots(tree, prefix: tuple = (), out: Optional[Slots] = None) -> Slots:
    """Checkpoint key -> [(layer index, leaf)]: one entry with index ()
    for a whole leaf, one per layer for a restacked parameter."""
    out = {} if out is None else out
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if _is_leaf(tree):
        out.setdefault("/".join(prefix), []).append(((), tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):      # NamedTuple
        for f in tree._fields:
            _slots(getattr(tree, f), prefix + ("." + f,), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _slots(v, prefix + (str(i),), out)
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            path, idx = stack_index(str(k))
            if idx or len(path) > 1:
                if not _is_leaf(v):
                    raise TypeError(f"{k!r}: a parameter name must hold a tensor")
                out.setdefault("/".join(prefix + path), []).append((idx, v))
            else:
                _slots(v, prefix + path, out)
    else:
        raise TypeError(f"checkpoint leaf of type {type(tree).__name__} at {'/'.join(prefix)}")
    return out


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (bf16 widened to f32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` copied to the host, by checkpoint key."""
    return {key: stack_rows({i: _host(leaf) for i, leaf in parts}, key)
            for key, parts in _slots(tree).items()}


def _digest(keys, get) -> str:
    h = hashlib.sha256()
    for k in sorted(keys):
        h.update(k.encode())
        h.update(np.ascontiguousarray(get(k)).tobytes())
    return h.hexdigest()


def _write(directory: str, step: int, flat: Dict[str, np.ndarray], extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _DATA), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "hash": _digest(flat, flat.__getitem__),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree: Any, *, extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write; returns the final checkpoint path."""
    return _write(directory, step, _flatten(tree), extra)


def list_checkpoints(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return [
        os.path.join(directory, d)
        for d in sorted(os.listdir(directory))
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, _MANIFEST))
    ]


@torch.no_grad()
def _restore(leaf, src: np.ndarray, key: str) -> None:
    if tuple(src.shape) != tuple(leaf.shape):
        raise ValueError(f"{key}: checkpoint shape {src.shape}, the target's {tuple(leaf.shape)}")
    if isinstance(leaf, torch.Tensor):
        leaf.copy_(torch.from_numpy(np.array(src, order="C")))
    elif isinstance(leaf, np.ndarray):
        np.copyto(leaf, src.astype(leaf.dtype))
    else:
        raise TypeError(f"{key}: cannot restore into a {type(leaf).__name__} in place")


def load_checkpoint(
    directory_or_path: str, tree_like: Any, *, verify: bool = True
) -> tuple[Any, int, dict]:
    """Restore into ``tree_like``'s tensors in place (the latest checkpoint
    under a directory, or the given one); returns ``(tree_like, step,
    extra)``. Raises ``IOError`` on a hash mismatch and ``KeyError`` when
    the checkpoint lacks a key of ``tree_like``."""
    path = directory_or_path
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        cks = list_checkpoints(directory_or_path)
        if not cks:
            raise FileNotFoundError(f"no checkpoints under {directory_or_path}")
        path = cks[-1]
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _DATA)) as z:
        data = {k: z[k] for k in z.files}
    if verify and _digest(manifest["keys"], data.__getitem__) != manifest["hash"]:
        raise IOError(f"checkpoint {path} failed hash verification")
    slots = _slots(tree_like)
    missing = set(slots) - set(manifest["keys"])
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    for key, parts in slots.items():
        for idx, leaf in parts:
            _restore(leaf, data[key][idx] if idx else data[key], key)
    return tree_like, manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """Retention + optional async writes (one outstanding save).

    ``save`` copies every leaf to the host before it returns, in both modes:
    the train step updates the tensors in place, so a writer thread reading
    them later would write a torn mix of two steps."""

    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save(self, step: int, flat, extra) -> None:
        try:
            _write(self.directory, step, flat, extra)
            self._gc()
        except BaseException as e:  # surfaced on next wait()/save()
            self._error = e

    def save(self, step: int, tree, *, extra: Optional[dict] = None) -> None:
        flat = _flatten(tree)          # snapshot off the device, now
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save, args=(step, flat, extra), daemon=True
            )
            self._thread.start()
        else:
            self._save(step, flat, extra)
            self.wait()

    def restore_latest(self, tree_like):
        self.wait()
        return load_checkpoint(self.directory, tree_like)

    def _gc(self) -> None:
        cks = list_checkpoints(self.directory)
        for old in cks[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)
