"""Async, atomic checkpointing of nested trees of tensors and numpy arrays.

Counterpart of ``repro.checkpoint.checkpointer``, with the same on-disk
layout per step::

    <dir>/step_<n>.tmp/           (written)
    <dir>/step_<n>/               (atomic rename on completion)
        manifest.json             leaf keys, files, shapes and dtypes
        leaf_<i>.npy              one file per leaf

A tree is any nesting of dicts (flattened in sorted key order), tuples,
lists and dataclasses, with ``torch.Tensor``, numpy arrays or scalars at
the leaves; ``None`` holds no leaf. Leaf keys are spelled as ``repro``'s
pytree paths are (``['carry'][0].v``).

* atomicity: a crash mid-write leaves only a ``.tmp`` directory, which
  ``latest_step`` never sees; a restart resumes from the previous complete
  step.
* async: ``save`` copies every leaf to the host first, then writes on a
  worker thread, so the caller is blocked only for the device-to-host copy.
  A failed write re-raises on the next ``wait()`` or ``save()``.
* custom dtypes: bfloat16 and the float8 types are stored as same-width
  unsigned integers, with the true dtype name in the manifest.
* restore: each leaf's shape is checked against the prototype's, and a
  tensor leaf comes back on the prototype's device, or on the mesh a
  matching tree of ``shardings``
  (:class:`~repro_torch.distributed.mesh.NamedSharding`) names.
* retention: the ``keep`` newest checkpoints are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.distributed.mesh import NamedSharding, tree_map

__all__ = ["Checkpointer"]

# numpy has no bfloat16 / float8: store them as same-width unsigned views and
# record the true dtype in the manifest
_CUSTOM_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_TORCH_NAMES = {v[0]: k for k, v in _CUSTOM_DTYPES.items()}


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """``(numpy array as stored, dtype name)`` of one leaf, copied to the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        # a device tensor's host copy is already private; a host tensor is copied
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        name = _TORCH_NAMES.get(t.dtype)
        if name is not None:
            _, same_width, np_view = _CUSTOM_DTYPES[name]
            return t.contiguous().view(same_width).numpy().view(np_view), name
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _from_stored(a: np.ndarray, dtype_name: str, proto):
    """The stored array as the prototype's kind of leaf (tensor on its device)."""
    if isinstance(proto, torch.Tensor):
        a = np.array(a, order="C")  # keeps a 0-dim leaf 0-dim
        if dtype_name in _CUSTOM_DTYPES:
            torch_dtype, same_width, _ = _CUSTOM_DTYPES[dtype_name]
            signed = np.int16 if same_width == torch.int16 else np.uint8
            t = torch.from_numpy(a.view(signed)).view(torch_dtype)
        else:
            t = torch.from_numpy(a)
        return t.to(proto.device)
    if dtype_name in _CUSTOM_DTYPES:
        raise ValueError(f"a {dtype_name} leaf restores only into a tensor prototype")
    return a


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """``[(key, leaf)]`` in a fixed order: dict keys sorted, sequences and
    dataclass fields in order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, f"{path}[{i}]")
        return out
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            out += _flatten(getattr(tree, f.name), f"{path}.{f.name}")
        return out
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {path or 'the root'}")


def _unflatten(proto, leaves):
    """Rebuild ``proto``'s structure from an iterator of restored leaves."""
    if proto is None:
        return None
    if _is_leaf(proto):
        return next(leaves)
    if isinstance(proto, dict):
        out = {k: _unflatten(proto[k], leaves) for k in sorted(proto)}
        return {k: out[k] for k in proto}
    if isinstance(proto, (tuple, list)):
        items = [_unflatten(x, leaves) for x in proto]
        if hasattr(proto, "_fields"):  # a namedtuple
            return type(proto)(*items)
        return type(proto)(items)
    fields = {f.name: _unflatten(getattr(proto, f.name), leaves)
              for f in dataclasses.fields(proto)}
    return dataclasses.replace(proto, **fields)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        # an async write's exception must not vanish with its daemon thread:
        # it is kept here and re-raised on the next wait()/save()
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()  # one outstanding save at a time; re-raises a failed one
        flat = _flatten(tree)
        keys = [k for k, _ in flat]
        host = [_to_host(x) for _, x in flat]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for i, (k, (a, dtype_name)) in enumerate(zip(keys, host)):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
                manifest["leaves"].append(
                    {"key": k, "file": f"leaf_{i}.npy", "dtype": dtype_name,
                     "shape": list(a.shape)}
                )
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        def _write_guarded():
            # atomic on failure too: the rename never ran, so only the .tmp
            # directory can exist; remove it so no half-written step remains
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 (re-raised in wait())
                self._error = e
                shutil.rmtree(os.path.join(self.dir, f"step_{step}.tmp"),
                              ignore_errors=True)

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_guarded, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the outstanding async save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like, shardings=None):
        """The tree saved at ``step``, in the structure of the prototype
        ``like``; tensor leaves go to the prototype leaf's device. With
        ``shardings`` (a tree matching ``like`` of ``NamedSharding`` s)
        every leaf comes back as a tensor placed on its mesh instead:
        reshard on load, as ``repro``'s ``shardings`` does."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        restored = []
        for k, p in _flatten(like):
            if k not in by_key:
                raise ValueError(
                    f"checkpoint step {step} has no leaf {k!r} — the saved "
                    "tree's structure differs from the restore prototype"
                )
            e = by_key[k]
            # a silent shape mismatch would splice another geometry's state
            # into the caller's tree; fixed-size prototypes must match
            # exactly (variable-length leaves opt out with a 0-size proto)
            want = tuple(p.shape) if hasattr(p, "shape") else ()
            got = tuple(e["shape"])
            if want != got and int(np.prod(want)) != 0:
                raise ValueError(
                    f"checkpoint step {step} leaf {k!r} has shape {got}, "
                    f"restore prototype expects {want}"
                )
            a = np.load(os.path.join(path, e["file"]))
            restored.append(_from_stored(a, e["dtype"], p))
        tree = _unflatten(like, iter(restored))
        if shardings is None:
            return tree
        return tree_map(lambda sharding, leaf: sharding.place(leaf), shardings, tree,
                        is_leaf=lambda s: isinstance(s, NamedSharding))
