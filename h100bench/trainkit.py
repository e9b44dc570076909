"""What the two training runners share: the data, the Trainer with the
benchmark's draws and spans around its calls, the checked first steps,
and the comparison that decides ``correct``.

Set-up builds one Trainer (the model with the seeded weights, the
optimizer state, the train step) and drives it from the seed through its
first ``check_steps`` steps: ``Trainer.train_epoch`` over a feed of that
many batches of distinct training rows (the window's own call and feed),
then ``valid_epoch`` once. The same object then trains in the window. The
shuffle and the augmentation draws are the benchmark's (drawn from its own
generator in the formats the Trainer takes), so that the reference
follows the checked steps on the same rows and draws.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from h100bench import checks, core, program, scenes, trace
from h100bench import reference
from h100bench.reference import train as ref_train


class Kit:
    """One cell's Trainer and what set-up recorded of its first steps."""

    def __init__(self, r: core.Run):
        from robocupvision_tpu_torch.data.device_cache import DeviceCache
        from robocupvision_tpu_torch.device import no_tf32
        from robocupvision_tpu_torch.train import optim
        from robocupvision_tpu_torch.train import step as tstep
        from robocupvision_tpu_torch.train.loop import Trainer

        self.r, tr = r, r.traffic
        cfg = r.config
        if cfg["train"]["dtype"] != "float32" or cfg["train"]["tf32"]:
            raise ValueError("the training cells train in f32, TF32 off")
        no_tf32()   # as train_combo and train_segmenter set it
        dev = r.device
        r.phase("imports")
        self.model, self.p0 = program.model(cfg, core.sub_seed(r.seed, 0),
                                            dev)
        r.phase("weights")
        if self.model.dropout_sites:
            raise ValueError("the reference takes no dropout keep masks")
        h, w = cfg["train"]["size"]
        n_tr, n_va, b = tr["train_images"], tr["val_images"], tr["batch"]
        self.k = tr["check_steps"]
        gen = torch.Generator(device=dev).manual_seed(core.sub_seed(r.seed, 1))
        u8, labs = scenes.draw_u8(gen, n_tr + n_va, h, w)
        imgs = scenes.normalized(u8, tr["normalize"])
        del u8
        self.train_cache = DeviceCache(imgs[:n_tr], labs[:n_tr], n_tr)
        self.val_cache = DeviceCache(imgs[n_tr:], labs[n_tr:], n_va)
        m = self.k * b
        self.check_rows = (imgs[:m].clone(), labs[:m].clone())
        r.phase("data")
        opt = tr["optimizer"]
        self.lr = opt["lr"]
        if opt["name"] == "adam":
            tx = optim.adam()
        elif opt["name"] == "sgd":
            tx = optim.sgd(momentum=opt["momentum"],
                           weight_decay=opt["weight_decay"])
        else:
            raise ValueError(opt["name"])
        step_cfg = tstep.StepCfg(
            num_classes=cfg["cfg"]["num_classes"], loss="ce2d",
            class_weights=tuple(tr["class_weights"]),
            l1_decay=tr.get("l1_decay", 0.0), augment=True,
            augment_mode=tr["augment"], out_size=1.0 / (h * w))
        mult = optim.transfer_multipliers(self.model.param_order, 0) \
            if tr.get("transfer_multipliers") else None
        self.tr = Trainer(self.model, tx, step_cfg,
                          DeviceCache(*self.check_rows, m), self.val_cache, b,
                          multipliers=mult)
        self.tr.init()
        # the benchmark's draws, recorded for the reference's steps
        dgen = torch.Generator(device=dev).manual_seed(
            core.sub_seed(r.seed, 2))
        draw = ref_train.DRAWS[tr["augment"]]
        self.perms: List[torch.Tensor] = []
        self.draws: List[dict] = []

        def draw_perm(n):
            p = torch.randperm(n, generator=dgen, device=dev)
            self.perms.append(p)
            return p

        def draw_augment(n):
            d = draw(dgen, n)
            if len(self.draws) < self.k:
                self.draws.append(d)
            return d

        self.tr.draw_perm, self.tr.draw_augment = draw_perm, draw_augment
        self.steps: List[tuple] = []    # (loss, new state) of checked steps
        self.evals: List[tuple] = []    # a validation's K1 counts
        self.capture = True
        self.n_steps = 0
        self._wrap()

    def _wrap(self) -> None:
        tr, r = self.tr, self.r
        step, ev = tr.train_step, tr.eval_step
        epoch, valid = tr.train_epoch, tr.valid_epoch

        def train_step(*args):
            t0 = time.perf_counter()
            new, out = step(*args)
            r.spans.append(core.Span("train_step", t0, time.perf_counter()))
            self.n_steps += 1
            if self.capture and len(self.steps) < self.k:
                self.steps.append((out["loss"], new))
            return new, out

        def eval_step(imgs, tgt, mask, params=None):
            t0 = time.perf_counter()
            out = ev(imgs, tgt, mask, params)
            r.spans.append(core.Span("eval_step", t0, time.perf_counter()))
            if self.capture:
                acc = out["acc"]
                self.evals.append((out["pred"].to(torch.uint8), tgt,
                                   acc.conf, acc.lab_cnts, acc.correct))
            return out

        def timed(name, fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                r.spans.append(core.Span(name, t0, time.perf_counter()))
                return out
            return call

        tr.train_step, tr.eval_step = train_step, eval_step
        tr.train_epoch = timed("train_epoch", epoch)
        tr.valid_epoch = timed("valid_epoch", valid)

    def warm_up(self) -> None:
        """The checked steps, then one validation; then the whole train
        set becomes the Trainer's feed."""
        self.r.phase("trainer")
        self.tr.train_epoch(self.lr)
        self.r.phase("checked_steps")
        self.tr.valid_epoch()
        self.capture = False
        self.tr.train_cache = self.train_cache
        self.r.spans.clear()
        self.n_steps = 0
        if self.r.device.type == "cuda":
            torch.cuda.synchronize()

    def traced_epoch(self) -> None:
        """One more epoch and its validation, under the profiler."""
        if not self.r.trace:
            return
        n0 = self.n_steps

        def segment():
            self.tr.train_epoch(self.lr)
            self.tr.valid_epoch()

        self.r.traced = trace.profile(segment, self.r.spans)
        self.r.counts["traced_steps"] = self.n_steps - n0

    def end_window(self, t0: float, epochs: int) -> None:
        r = self.r
        r.window = (t0, time.perf_counter())
        r.counts.update(epochs=epochs, steps=self.n_steps,
                        images=epochs * r.traffic["train_images"])
        r.attempted = r.counts["images"]
        if r.device.type == "cuda":
            r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)

    # -- the comparison ---------------------------------------------------

    def program_side(self) -> dict:
        """The checked steps as the program took them: each loss, the first
        gradient as the optimizer got it (from its state after one step),
        the params after the last."""
        opt = self.r.traffic["optimizer"]
        losses = [float(loss) for loss, _ in self.steps]
        st1 = self.steps[0][1]
        grads = {}
        for k in self.p0:
            if not ref_train.is_trainable(k):
                continue
            if opt["name"] == "adam":      # mu = (1 - b1) g after one step
                grads[k] = st1.opt_state["mu/" + k] / (1.0 - 0.9)
            else:                          # trace = g + wd p0
                grads[k] = st1.opt_state["trace/" + k] \
                    - opt["weight_decay"] * self.p0[k]
        params = {k: v for k, v in self.steps[-1][1].params.items()
                  if ref_train.is_trainable(k)}
        return {"losses": losses, "grads": grads, "params": params}

    def release(self) -> None:
        """Free the program's state but what the comparison reads."""
        self.side = self.program_side()
        del self.tr, self.train_cache, self.val_cache, self.steps
        del self.model
        if self.r.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_side(self, tf32: bool = False, half: bool = False) -> dict:
        """The reference's steps on the checked rows and draws (``tf32``:
        computed with TF32 on, the control; ``half``: half of each batch
        left out and the mean taken over the rest, a fault)."""
        r, b = self.r, self.r.traffic["batch"]
        imgs, labs = self.check_rows
        perm = self.perms[0]
        keep = b // 2 if half else b
        batches, draws = [], []
        for i in range(self.k):
            idx = perm[i * b:i * b + keep]
            batches.append((imgs[idx], labs[idx]))
            draws.append({k: v[:keep] for k, v in self.draws[i].items()})
        fwd = core.load_module("families", r.config["family"]).forward
        cfg = r.config["cfg"]
        with reference.tf32(tf32):
            return ref_train.run_steps(
                lambda p, x: fwd(p, cfg, x, train=True), self.p0, batches,
                draws, r.traffic["augment"], r.traffic["class_weights"],
                r.traffic.get("l1_decay", 0.0), r.traffic["optimizer"])

    def gaps(self, side: dict, ref: dict) -> Dict[str, float]:
        return checks.train_gaps(side, ref, self.p0)

    def judge(self) -> None:
        """Release the program, run the reference, record the numbers."""
        self.release()
        got = self.gaps(self.side, self.reference_side())
        got["k1_count_gap"] = checks.k1_count_gap(self.evals)
        for name in self.r.limits:   # the numbers the cell compares
            self.r.compare(name, got[name])
