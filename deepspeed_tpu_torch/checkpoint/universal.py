"""Universal checkpoint: a topology-independent parameter-atom format.

A copy of ``deepspeed_tpu/checkpoint/universal.py`` (numpy and file code,
kept here so that the port imports nothing of the JAX package); the files
it reads and writes are the same.  Counterpart of the reference's universal checkpoint
(deepspeed/checkpoint/ds_to_universal.py:286 — extract_zero_shards:87 /
merge_tp_slices:156 — and universal_checkpoint.py:load_hp_checkpoint_state:12):
a ZeRO checkpoint is converted into one directory per parameter holding fp32
"atoms" (weight + optimizer moments), reloadable at ANY dp/tp/pp/ep topology.

Our native checkpoints already store full (unsharded) leaves, so conversion is
a re-layout: params + matching optimizer moments are grouped per-parameter
under ``zero/<param_key>/{fp32,exp_avg,exp_avg_sq}.npy`` exactly mirroring the
reference's atom naming, plus a model-only ``model/`` tree (bf16-convertible)
and metadata.  ``load_universal`` rebuilds an engine TrainState regardless of
the saving topology; vocab-padding fixups (reference merge_tp_slices:156-220)
are handled by ``--strip-vocab-padding`` trimming dim 0 to the model's vocab.
"""

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

# The param atom is always "fp32" (reference ds_to_universal.py atom naming);
# optimizer atoms are DISCOVERED from the opt_state tree, so lion (mu), lamb,
# sgd momentum and 1-bit states survive conversion — not just Adam's
# exp_avg/exp_avg_sq (the reference hardcodes those).
PARAM_ATOM = "fp32"


def _discover_atoms(keys, param_paths: List[str]) -> "tuple[Dict[str, Dict[str, str]], set]":
    """Map each param path to {atom_name: checkpoint_key} by matching optimizer
    leaves ``opt_state.<atom>.<param_path>`` (optax state trees mirror the param
    tree, possibly nested — the atom name is whatever sits between).  Longest
    param-path suffix wins, so sibling paths that suffix-overlap resolve to the
    most specific parameter."""
    by_len = sorted(param_paths, key=len, reverse=True)
    atoms: Dict[str, Dict[str, str]] = {p: {} for p in param_paths}
    matched = set()
    for k in keys:
        if not k.startswith("opt_state."):
            continue
        rest = k[len("opt_state."):]
        for p in by_len:
            if rest.endswith("." + p):
                atoms[p][rest[:-(len(p) + 1)]] = k
                matched.add(k)
                break
    return atoms, matched


def _load_manifest(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, "metadata.json")) as fh:
        return json.load(fh)


def ds_to_universal(ckpt_dir: str, out_dir: str, strip_vocab_padding: Optional[int] = None) -> str:
    """Convert a native checkpoint directory into the universal atom layout.

    Returns ``out_dir``.  Reference CLI: python -m deepspeed.checkpoint.ds_to_universal.
    """
    meta = _load_manifest(ckpt_dir)
    keys = [m["key"] for m in meta["manifest"]]
    param_keys = [k for k in keys if k.startswith("params.")]
    param_paths = [k[len("params."):] for k in param_keys]
    os.makedirs(os.path.join(out_dir, "zero"), exist_ok=True)
    atom_map, matched = _discover_atoms(keys, param_paths)

    index = {}
    for pk, ppath in zip(param_keys, param_paths):
        atom_dir = os.path.join(out_dir, "zero", ppath)
        os.makedirs(atom_dir, exist_ok=True)
        arr = np.load(os.path.join(ckpt_dir, pk + ".npy")).astype(np.float32)
        padded_dim0 = arr.shape[0] if arr.ndim else None
        stripped = (strip_vocab_padding and arr.ndim >= 1 and arr.shape[0] > strip_vocab_padding)
        if stripped:
            arr = arr[:strip_vocab_padding]
        np.save(os.path.join(atom_dir, PARAM_ATOM + ".npy"), arr)
        atoms = {PARAM_ATOM: list(arr.shape)}
        for name, mk in sorted(atom_map[ppath].items()):
            marr = np.load(os.path.join(ckpt_dir, mk + ".npy"))
            if stripped and marr.dtype == np.int8:
                # quantized moments (fused_adam8bit) store flat (groups,
                # group_size) blocks — dim 0 is GROUPS, not the vocab dim, so
                # a row-strip here would silently desync moments from the
                # stripped param.  Refuse rather than corrupt.
                raise ValueError(
                    f"--strip-vocab-padding cannot re-layout quantized int8 moment "
                    f"atom {mk} ({ppath}): dequantize first (load with "
                    f"fused_adam8bit, re-save with adamw) or convert without "
                    f"stripping")
            # cast float atoms to fp32 (universal format contract); keep
            # integer/bool aux leaves (e.g. step counters) in their dtype
            if np.issubdtype(marr.dtype, np.floating):
                marr = marr.astype(np.float32)
            if stripped and marr.ndim >= 1 and marr.shape[0] == padded_dim0:
                marr = marr[:strip_vocab_padding]
            os.makedirs(os.path.dirname(os.path.join(atom_dir, name + ".npy")), exist_ok=True)
            np.save(os.path.join(atom_dir, name + ".npy"), marr)
            atoms[name] = list(marr.shape)
        index[ppath] = atoms

    # Everything not absorbed into a parameter atom passes through verbatim:
    # opt_state.step (Adam bias-correction counter), optimizer scalars with no
    # per-param shape, loss scale, rng, scheduler state.  Conversion is
    # lossless for ANY optimizer shape.
    passthrough = {}
    for k in keys:
        if not k.startswith("params.") and k not in matched:
            shutil.copy(os.path.join(ckpt_dir, k + ".npy"), os.path.join(out_dir, k + ".npy"))
            passthrough[k] = True
    with open(os.path.join(out_dir, "universal_metadata.json"), "w") as fh:
        json.dump({"version": 1, "params": index, "passthrough": sorted(passthrough),
                   # recorded so loaders re-pad ONLY genuinely stripped atoms
                   # (a bare dim-0 mismatch must stay a hard error)
                   "strip_vocab_padding": strip_vocab_padding,
                   "client_state": meta.get("client_state", {})}, fh, indent=1)
    logger.info(f"universal checkpoint: {len(index)} parameter atoms -> {out_dir}")
    return out_dir


def load_universal(universal_dir: str) -> Dict[str, Any]:
    """Read a universal checkpoint into {param_path: {atom: np.ndarray}} plus
    metadata — the reshape-on-load half (reference load_hp_checkpoint_state)."""
    with open(os.path.join(universal_dir, "universal_metadata.json")) as fh:
        meta = json.load(fh)
    out = {}
    for ppath, atoms in meta["params"].items():
        adir = os.path.join(universal_dir, "zero", ppath)
        out[ppath] = {name: np.load(os.path.join(adir, name + ".npy"))
                      for name in atoms}
    return {"params": out, "client_state": meta.get("client_state", {}),
            "strip_vocab_padding": meta.get("strip_vocab_padding"),
            "passthrough": {k: np.load(os.path.join(universal_dir, k + ".npy"))
                            for k in meta.get("passthrough", [])}}


def zero_to_fp32(ckpt_dir: str, output_file: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Consolidate a checkpoint's model weights into one fp32 state dict
    (reference deepspeed/utils/zero_to_fp32.py, shipped into every ckpt dir).

    Our leaves are stored full, so this extracts+casts params; optionally saves
    an .npz for offline use."""
    meta = _load_manifest(ckpt_dir)
    out = {}
    for m in meta["manifest"]:
        if m["key"].startswith("params."):
            arr = np.load(os.path.join(ckpt_dir, m["key"] + ".npy")).astype(np.float32)
            out[m["key"][len("params."):]] = arr
    if output_file:
        np.savez(output_file, **out)
        logger.info(f"consolidated {len(out)} fp32 tensors -> {output_file}")
    return out


def main(argv=None):
    """CLI: python -m deepspeed_tpu_torch.checkpoint.universal <ckpt_dir> <out_dir>
    [--strip-vocab-padding N] | --zero-to-fp32 <ckpt_dir> <out.npz>"""
    import argparse
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("ckpt_dir")
    parser.add_argument("out")
    parser.add_argument("--strip-vocab-padding", type=int, default=None)
    parser.add_argument("--zero-to-fp32", action="store_true")
    args = parser.parse_args(argv)
    if args.zero_to_fp32:
        zero_to_fp32(args.ckpt_dir, args.out)
    else:
        ds_to_universal(args.ckpt_dir, args.out, strip_vocab_padding=args.strip_vocab_padding)


if __name__ == "__main__":
    main()
