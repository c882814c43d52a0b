"""Pretrain -> finetune weight transfer, over torch state dicts.

Port of ``gm3d_tpu/ckpt/transfer.py``. The reference loads a pretrain
checkpoint into ``PointTransformer`` with ``strict=False`` after stripping
the ``MAE_encoder.`` / ``base_model.`` / ``module.`` key prefixes
(``main_finetune.py:297-324``, ``models/Point_MAE.py:511-543``). The JAX
package does that surgery on flax trees; here it is done on the state dicts
under the reference's names, which the port's models load. The same overlay
serves the part-segmentation model: ``PointMAESeg`` names its encoder and
blocks as ``PointTransformer`` does (``blocks.blocks.{i}``), so the JAX
overlay's ``flatten=("blocks",)`` (its seg model holds the blocks at the
root) has no counterpart here, and the seg model's lack of a final LayerNorm
leaves the checkpoint's among the unexpected keys, as there. One report
differs, no weight: the GM3D student's feature head is ``head_fc1`` /
``head_fc2`` in its flax tree, the seg head's names, so the JAX overlay lists
those four leaves as shape mismatches; under their torch names
(``increase_dim_2.*``) they are unexpected here.

One name differs between the two spaces: the encoder's final LayerNorm is
``norm`` in every flax tree, but ``norm_p`` in ``PointTransformer`` and the
GM3D student and ``norm`` in the Point-MAE pretrain model under the
reference's names (``ckpt/torch_import.py``). Keys are therefore matched
under the flax spelling of that LayerNorm, so that a Point-MAE pretrain
hands its final LayerNorm to the finetune model, as the JAX overlay does.

``num_batches_tracked``, a torch-only BatchNorm counter with no flax
counterpart, is neither transferred nor counted: the destination keeps its
own, and the counts equal the JAX report's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from gm3d_tpu_torch.ckpt.checkpoint import restore_raw
from gm3d_tpu_torch.ckpt.torch_import import POINT_TRANSFORMER_MAP, load_torch_file

_TOP_LEVEL = ("cls_token", "cls_pos", "mask_token", "mask_token_loss_pred")
_COUNTER = "num_batches_tracked"


def group_paths(paths: List[str]) -> List[str]:
    """Collapse numbered siblings into one line (detectron2-style grouped key
    reports, reference ``utils/checkpoint.py:16-132``): paths differing only
    in digit runs render as ``blocks.blocks.*.attn.qkv.weight x12``."""
    groups: dict = {}
    for p in paths:
        groups.setdefault(re.sub(r"\d+", "*", p), []).append(p)
    lines = []
    for tmpl in sorted(groups):
        ps = groups[tmpl]
        lines.append(ps[0] if len(ps) == 1 else f"{tmpl} x{len(ps)}")
    return lines


class TransferReport:
    """Per-key record of a checkpoint-surgery overlay, under the reference's
    torch names. Fields:

    - ``matched``: destination keys that received a source value;
    - ``missing``: destination keys NOT covered by the source (left at their
      fresh init: fine for the head, suspicious for the encoder);
    - ``unexpected``: source keys with no destination counterpart (after the
      ``MAE_encoder.`` strip);
    - ``shape_mismatch``: name-matched keys skipped for differing shapes;
    - ``torch_unmatched``: keys of a ``.pth`` (after the strip) that the
      ``PointTransformer`` name map does not know (not overlaid).
    """

    def __init__(self):
        self.matched: List[str] = []
        self.missing: List[str] = []
        self.unexpected: List[str] = []
        self.shape_mismatch: List[Tuple[str, tuple, tuple]] = []
        self.torch_unmatched: List[str] = []

    @property
    def matched_fraction(self) -> float:
        total = len(self.matched) + len(self.missing)
        return len(self.matched) / total if total else 0.0

    def lines(self) -> List[str]:
        out = [f"transfer: {len(self.matched)} leaves overlaid "
               f"({self.matched_fraction:.0%} of the destination tree)"]
        if self.missing:
            out.append(f"  missing (left at fresh init, {len(self.missing)}):")
            out += [f"    {line}" for line in group_paths(self.missing)]
        if self.unexpected:
            out.append(f"  unexpected in checkpoint ({len(self.unexpected)}):")
            out += [f"    {line}" for line in group_paths(self.unexpected)]
        if self.shape_mismatch:
            out.append(f"  shape mismatches (skipped, {len(self.shape_mismatch)}):")
            out += [f"    {p}: ckpt{tuple(s)} vs model{tuple(d)}"
                    for p, s, d in self.shape_mismatch]
        if self.torch_unmatched:
            out.append(f"  torch keys unrecognized by the import map "
                       f"({len(self.torch_unmatched)}):")
            out += [f"    {line}" for line in group_paths(self.torch_unmatched)]
        return out

    def log(self, logger) -> None:
        """Grouped report; WARNING when the overlay was partial or skipped
        shape-mismatched keys, INFO otherwise."""
        if logger is None:
            return
        partial = self.matched_fraction < 1.0 or self.shape_mismatch
        emit = logger.warning if partial else logger.info
        for line in self.lines():
            emit(line)


def strip_mae_encoder(src: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the ``MAE_encoder.`` prefix of every key (``main_finetune.py:
    312-313``). A stripped key wins over a root key of the same name, as the
    JAX re-rooting lets the encoder's subtree win."""
    out = {k: v for k, v in src.items() if not k.startswith("MAE_encoder.")}
    out.update({k[len("MAE_encoder."):]: v for k, v in src.items()
                if k.startswith("MAE_encoder.")})
    return out


def _flax_spelling(key: str) -> str:
    """The key with the encoder's final LayerNorm under its flax name."""
    return "norm." + key[len("norm_p."):] if key.startswith("norm_p.") else key


def overlay_pretrained(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
                       report: Optional[TransferReport] = None
                       ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Overlay pretrain weights ``src`` (``MAE_encoder.`` stripped) onto a
    fresh finetune state dict ``dst``: every key whose name (final LayerNorm
    under its flax spelling) and shape match takes the source's value, cast
    to the destination's dtype and device. Returns ``(state_dict,
    n_transferred)``, a new dict (inputs are not mutated). Callers MUST check
    ``n_transferred > 0``."""
    src = strip_mae_encoder(src)
    by_name = {_flax_spelling(k): k for k in dst if not k.endswith(_COUNTER)}
    out = dict(dst)
    matched = []
    for key, value in src.items():
        if key.endswith(_COUNTER):
            continue
        target = by_name.get(_flax_spelling(key))
        if target is None:
            if report is not None:
                report.unexpected.append(key)
            continue
        want = dst[target]
        if tuple(value.shape) != tuple(want.shape):
            if report is not None:
                report.shape_mismatch.append((target, tuple(value.shape), tuple(want.shape)))
            continue
        out[target] = value.detach().to(dtype=want.dtype, device=want.device).clone()
        matched.append(target)
    if report is not None:
        report.matched += matched
        done = set(matched)
        report.missing = [k for k in by_name.values() if k not in done]
    return out, len(matched)


def _known_to(key: str, table: Mapping[str, Tuple[str, str]]) -> bool:
    """Whether the name map ``table`` knows the parameter or buffer ``key``."""
    if key in _TOP_LEVEL:
        return True
    m = re.match(r"^(.*)\.(weight|bias|running_mean|running_var)$", key)
    if not m:
        return False
    # the Point-MAE encoder's final LayerNorm is ``norm_p`` in the map
    module = "norm_p" if m.group(1) == "norm" else m.group(1)
    return any(re.fullmatch(re.escape(pat).replace(r"\{i\}", r"\d+"), module)
               for pat in table)


def load_pretrained_into(model: torch.nn.Module, pretrained: str, torch_ckpt: bool = False,
                         logger=None) -> Tuple[int, TransferReport]:
    """The pretrain -> finetune load of the finetune, few-shot and
    segmentation CLIs, in place and ``strict=True``. ``pretrained`` is a
    checkpoint root written by the port's pretrain CLI (its latest step's
    ``model``, GM3D or Point-MAE), or, with ``torch_ckpt``, a reference
    ``.pth``. A missing checkpoint raises
    ``FileNotFoundError``; a checkpoint that transfers nothing raises
    ``ValueError``. Returns ``(n_transferred, report)``."""
    report = TransferReport()
    if torch_ckpt:
        sd = {k: v for k, v in load_torch_file(pretrained).items() if not k.endswith(_COUNTER)}
        sd = strip_mae_encoder(sd)
        src = {k: v for k, v in sd.items() if _known_to(k, POINT_TRANSFORMER_MAP)}
        report.torch_unmatched = [k for k in sd if k not in src]
    else:
        raw = restore_raw(pretrained)
        if raw is None:
            raise FileNotFoundError(f"no checkpoint found under {pretrained}")
        src = raw["model"]
    new, n = overlay_pretrained(model.state_dict(), src, report=report)
    if n == 0:
        raise ValueError(
            f"pretrained checkpoint {pretrained!r} transferred 0 parameters: layout "
            "mismatch (expected MAE_encoder.* or root-level encoder keys)")
    model.load_state_dict(new, strict=True)
    if logger:
        logger.info(f"pretrain->finetune transfer: {n} leaves overlaid from {pretrained}")
        report.log(logger)
    return n, report
