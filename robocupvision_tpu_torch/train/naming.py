"""Checkpoint file names of the reference (the JAX package's
train/naming.py): train.py writes ``checkpoints/best{Finetune}{v2}{VGA}
{UNet}{NoBall}{NoGoal}{NoRobot}{NoLine}{cam}{T<transfer>}{<pct>_<mflops>}
.weights`` (train.py:180-201) and loads the un-finetuned one for
``--finetune`` (train.py:256); the legacy pipeline
writes ``pth/bestModel{Seg}{VGA}{v2}{NoBall}{NoGoal}{NoRobot}{NoLine}{cam}
{Finetuned}{Pruned|Pruned2}.pth`` (reference trainer.py:149, 310;
pruner.py:134, 291), and test.py evaluates the family
``checkpoints/best{Finetune}{v2}{VGA}{UNet}{NoBall}{NoGoal}{NoRobot}
{NoLine}{cam}*.weights`` (test.py:264)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Flags:
    finetune: bool = False
    v2: bool = False
    no_scale: bool = False
    unet: bool = False
    no_ball: bool = False
    no_goal: bool = False
    no_robot: bool = False
    no_line: bool = False
    top_cam: bool = False
    bottom_cam: bool = False

    @property
    def camera(self) -> str:
        if self.top_cam == self.bottom_cam:
            return "both"
        return "top" if self.top_cam else "bottom"

    @property
    def camera_str(self) -> str:
        """Empty when both cameras (reference train.py:249)."""
        return "" if self.top_cam == self.bottom_cam else self.camera

    @property
    def num_classes(self) -> int:
        return 5 - self.no_ball - self.no_goal - self.no_robot - self.no_line

    def parts(self) -> str:
        return (("v2" if self.v2 else "") + ("VGA" if self.no_scale else "")
                + ("UNet" if self.unet else "") + ("NoBall" if self.no_ball else "")
                + ("NoGoal" if self.no_goal else "") + ("NoRobot" if self.no_robot else "")
                + ("NoLine" if self.no_line else ""))


def train_ckpt_name(f: Flags, transfer: int = 0, pruned: bool = False,
                    prune_pct: int = 0, mflops: int = 0) -> str:
    """train.py's checkpoints/<name>.weights (train.py:180-201)."""
    name = "bestFinetune" if f.finetune else "best"
    # reference order: v2, VGA, UNet, NoBall, NoGoal, NoRobot, NoLine, cam
    name += ("v2" if f.v2 else "") + ("VGA" if f.no_scale else "")
    name += ("UNet" if f.unet else "")
    name += ("NoBall" if f.no_ball else "") + ("NoGoal" if f.no_goal else "")
    name += ("NoRobot" if f.no_robot else "") + ("NoLine" if f.no_line else "")
    name += f.camera_str if f.finetune else ""
    if transfer != 0:
        name += "T%d" % transfer
    if pruned:
        name += "%d_%d" % (prune_pct, mflops)
    return "checkpoints/%s.weights" % name


def train_load_name(f: Flags) -> str:
    """The un-finetuned weights train.py loads for --finetune (train.py:256)."""
    return "checkpoints/best%s%s%s%s%s%s%s%s.weights" % (
        "v2" if f.v2 else "", "VGA" if f.no_scale else "",
        "UNet" if f.unet else "", "NoBall" if f.no_ball else "",
        "NoGoal" if f.no_goal else "", "NoRobot" if f.no_robot else "",
        "NoLine" if f.no_line else "", f.camera_str if f.finetune else "")


def test_ckpt_glob_base(f: Flags) -> str:
    """test.py's checkpoint family base name (test.py:264)."""
    return "checkpoints/best%s%s%s%s%s%s%s%s%s" % (
        "Finetune" if f.finetune else "", "v2" if f.v2 else "",
        "VGA" if f.no_scale else "", "UNet" if f.unet else "",
        "NoBall" if f.no_ball else "", "NoGoal" if f.no_goal else "",
        "NoRobot" if f.no_robot else "", "NoLine" if f.no_line else "",
        f.camera_str if f.finetune else "")


def legacy_model_name(f: Flags, seg: bool = False, finetuned: bool = False,
                      pruned: str = "", camera: Optional[str] = None) -> str:
    """pth/bestModel... names of the legacy pipeline: classTrainer saves
    bestModel{VGA}{v2}{ablations}.pth (classTrainer.py:188), trainer
    bestModelSeg{VGA}{v2}{ablations}{cam}{Finetuned}{Pruned}.pth
    (trainer.py:310), and the pruner appends Pruned2 (pruner.py:291)."""
    name = "pth/bestModel"
    if seg:
        name += "Seg"
    name += ("VGA" if f.no_scale else "") + ("v2" if f.v2 else "")
    name += ("NoBall" if f.no_ball else "") + ("NoGoal" if f.no_goal else "")
    name += ("NoRobot" if f.no_robot else "") + ("NoLine" if f.no_line else "")
    if camera:
        name += camera
    if finetuned:
        name += "Finetuned"
    name += pruned
    return name + ".pth"
