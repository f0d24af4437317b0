"""Optional persistence of encrypted artifacts: ciphertexts and mid-run
executor slabs, as plain ``.npz`` (ciphertexts are uint32/uint64 torus
arrays — nothing secret beyond what the server already holds).

The JAX package's ``utils/checkpoint.py`` with the same functions,
signatures and return values, plus a circuit fingerprint: each
``save_*slab`` takes ``fingerprint=`` (stored as one more array, named
``fingerprint``) and ``load_fingerprint`` reads it back, so a resume can
refuse a slab saved by a different circuit.  Without a fingerprint a file
holds exactly the keys and arrays the JAX package writes.

A 64-bit slab is saved as the JAX package keeps it, ``[S, n+1, 2]`` uint32
limb pairs (low word first): the port's ``[S, n+1]`` int64 slab has the
same bytes.

Slabs are written with ``np.savez``, not the JAX module's
``np.savez_compressed`` (``np.load`` reads both): a slab is mostly
incompressible ciphertext, and on the serving configuration (113.6 MB)
compressing took about 1 s against 0.08 s uncompressed, longer than the
0.29 s launch step it checkpoints (NVIDIA H100 80GB HBM3 host,
chip_smoke.py phase 13).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def save_ciphertext(path, ct: np.ndarray, kind: str = "content") -> None:
    # keep the torus dtype as-is: uint32 (32-bit sets) or uint64 (reference
    # width) — an astype would silently truncate 64-bit ciphertexts
    np.savez_compressed(Path(path), kind=np.array(kind), ct=ct)


def load_ciphertext(path) -> np.ndarray:
    with np.load(Path(path)) as z:
        return z["ct"]


def _slab_words(slab) -> np.ndarray:
    """The slab as uint32 words: int32 as is, 64-bit words as limb pairs
    [..., 2] (the JAX package's layout of a 64-bit slab)."""
    a = np.ascontiguousarray(slab)
    if a.dtype.itemsize == 8:
        return a.view(np.uint32).reshape(a.shape + (2,))
    return a.view(np.uint32)


def _fingerprint_kw(fingerprint: Optional[str]) -> dict:
    return {} if fingerprint is None else {"fingerprint": np.array(fingerprint)}


def save_slab(path, slab, level_idx: int,
              fingerprint: Optional[str] = None) -> None:
    """Checkpoint an executor slab between levels (resume = rerun remaining
    levels on the restored slab)."""
    np.savez(Path(path), slab=_slab_words(slab),
             level_idx=np.array(level_idx), **_fingerprint_kw(fingerprint))


def load_slab(path):
    with np.load(Path(path)) as z:
        return z["slab"].view(np.int32), int(z["level_idx"])


def save_many_slab(path, slab, step_idx: int, n_contents: int,
                   total_steps: int, fingerprint: Optional[str] = None) -> None:
    """Checkpoint a packed run_many slab between launch steps.  A step is
    one classic chunk launch or one multivalue (rotations + finish) plan
    entry; the packed slab holds ALL contents, so resume = replay the
    remaining steps of the SAME (circuit, C, wide_batch) plan on the
    restored slab."""
    np.savez(Path(path), slab=_slab_words(slab),
             step_idx=np.array(step_idx), n_contents=np.array(n_contents),
             total_steps=np.array(total_steps), kind=np.array("run_many"),
             **_fingerprint_kw(fingerprint))


def load_many_slab(path):
    with np.load(Path(path)) as z:
        if "kind" not in z or str(z["kind"]) != "run_many":
            raise ValueError(f"{path}: not a run_many checkpoint")
        return (z["slab"].view(np.int32), int(z["step_idx"]),
                int(z["n_contents"]), int(z["total_steps"]))


def load_fingerprint(path) -> Optional[str]:
    """The circuit fingerprint a slab checkpoint was saved with, or None."""
    with np.load(Path(path)) as z:
        return str(z["fingerprint"]) if "fingerprint" in z else None
