"""Training traffic: the port's ``train_loop`` as ``cli.train`` drives it,
after the densify window of a 30,000-iteration run.

Set-up makes the cell's world (``world_seed``: every slot alive), its
targets, the world's own renders (``scenes/targets.py``), and Adam's
state ``start_iteration`` steps in from the run's seed, then drives the
training state through its first three steps with two calls of
``train_loop`` (one step, then two), as the window calls it: the losses,
the moments after the first step and the parameters after the third are
what the reference is held against.  Each call captures its own graph of
a ``fused_steps``-row table as the window's call does, and these steps
replay rows 0 and 0-1 of it; the window's own capture and rows 2 on are
not compared.  The window is a third call on that same state with
``TrainCallbacks(on_metrics=..., log_every=100)``, ``fused_steps`` 10, the
tiled rasterizer and no densification: its bounds are the loop's own
synced ``on_metrics`` calls, the first at or after ``warmup`` iterations
and the first past ``--seconds``, where the callback stops the loop by
raising.  The loop picks its views from the call's seed
(``pick_view_index``); the reference picks the same ones by the same rule.
"""

from __future__ import annotations

import gc
import math
import random
import time

import torch

from benchmark import program
from benchmark.compare import Check, leaf_gap, moved_leaves, relative_gap
from benchmark.counts import work
from benchmark.reference import splats
from benchmark.reference import train as ref
from benchmark.scenes import recipes, targets

TEST_VIEWS = (5, 25, 45, 65, 85)  # held out in the gray and event modes
STATS = ("grad_accum", "denom", "max_radii2d")
WINDOW_ITERATIONS = 1 << 30  # the window's call runs until the callback stops it
# the second moments' decay over three steps: nu₃ − β₂³·nu₀ is what Adam took
# in from the three gradients (nu₃ − nu₀ cancels against it)
DECAY3 = ref.B2 ** 3


class WindowClosed(Exception):
    """Raised from ``on_metrics`` at the window's end."""


def pick_view(rng: random.Random, n_views: int, mode: str) -> int:
    """The reference's view pick (``train.py``): event mode from [2, n-4],
    others from [2, n-3]; gray and event step down off a held-out view."""
    idx = rng.randint(2, n_views - 4) if mode == "event" else rng.randint(2, n_views - 3)
    if mode != "rgb" and idx in TEST_VIEWS:
        idx -= 1
    return idx


def call_seed(seed: int, k: int) -> int:
    """The seed of set-up's call ``k`` (0, 1) and of the window's (2)."""
    return recipes.sub_seed(seed, 10 + k) % (1 << 32)


def closing_params(tb):
    """The program's parameters where the window closed: those of the live
    state of the ``train_loop`` frame that the callback raised through (its
    ``state`` after the chunk that the closing log tick ends), or None where
    no such frame holds one."""
    state = None
    while tb is not None:
        frame = tb.tb_frame
        if frame.f_code.co_name == "train_loop":
            state = frame.f_locals.get("state", state)
        tb = tb.tb_next
    params = getattr(state, "params", None)
    if params is None:
        return None
    return {k: getattr(params, k).detach() for k in ref.LEAVES}


class Driver:
    def __init__(self, h):
        self.h, self.cfg, self.wl = h, h.cfg, h.wl
        self.mode = self.cfg["mode"]
        self.start = int(self.cfg["start_iteration"])
        self.world = int(self.wl["world_seed"])
        self.captures = []
        self.window_capture = math.nan  # ms of the window call's capture
        self.closing = None  # the parameters where the window closed
        self.seeds = [call_seed(h.seed, k) for k in range(3)]
        self.extent = recipes.nerfpp_extent(recipes.views(self.cfg, h.device))

    # --- the program's objects ---------------------------------------------

    def _scene(self):
        """The cameras and the target stacks (event mode: the event
        camera's frames at the same poses, a stack of their own)."""
        c, dev = self.cfg, self.h.device
        views = recipes.views(c, dev)
        scene = {"cameras": views,
                 "images": targets.targets(self.h.root, c, self.world, dev)}
        if self.mode == "event":
            scene["event_cameras"] = views
            scene["event_images"] = scene["images"].clone()
        return scene

    def _train_config(self, seed: int):
        from event3dgs_tpu_torch.utils.config import TrainConfig

        tc = TrainConfig()
        tc.model.sh_degree = int(self.cfg["sh_degree"])
        tc.pipeline.rasterizer = "tiled"
        tc.pipeline.fused_steps = int(self.wl["fused_steps"])
        tc.optimization.densify_until_iter = 0  # past the densify window
        tc.seed = seed
        return tc

    def _initial(self):
        """(the world's raw parameters, {leaf: (mu, nu)} from the run's
        seed, the contrast's among them)."""
        dev, seed = self.h.device, self.h.seed
        raw = recipes.cloud(self.cfg, self.world, dev)
        shapes = {k: tuple(v.shape) for k, v in raw.items()}
        shapes["contrast"] = ()
        moments = recipes.adam_moments(self.cfg, seed, shapes, dev)
        return raw, moments

    def setup(self):
        from event3dgs_tpu_torch.models.optimizer import AdamState
        from event3dgs_tpu_torch.train.state import SceneData, init_train_state

        program.build_kernels(self.wl["kernels"], self.h.device)
        dev = self.h.device
        scene = self._scene()
        cams = program.cameras(scene["cameras"])
        self.data = SceneData(
            cameras=cams, images=scene["images"],
            event_cameras=cams if self.mode == "event" else None,
            event_images=scene.get("event_images"))
        del scene
        raw, moments = self._initial()
        count = lambda: torch.full((), self.start, dtype=torch.int32, device=dev)
        c_mu, c_nu = moments.pop("contrast")
        state = init_train_state(program.gaussians(raw), self.extent,
                                 contrast_init=float(self.cfg["contrast_init"]),
                                 max_sh_degree=int(self.cfg["sh_degree"]))
        state = state.replace(
            opt_state=AdamState(mu={k: m for k, (m, _) in moments.items()},
                                nu={k: v for k, (_, v) in moments.items()},
                                count=count()),
            contrast_opt=AdamState(mu=c_mu, nu=c_nu, count=count()),
            step=torch.tensor(self.start, dtype=torch.int32))
        del raw, moments
        # the first three steps, through the window's own call
        self.h.log("scene made")
        a = self._loop(state, self.seeds[0], 1)
        del state
        self.h.log(f"step 1: loss {a.history}")
        self.losses = list(a.history)
        self.mu1 = {k: v.detach().to("cpu", copy=True)
                    for k, v in a.state.opt_state.mu.items()}
        self.mu1["contrast"] = a.state.contrast_opt.mu.detach().to("cpu", copy=True)
        b = self._loop(a.state, self.seeds[1], 2)
        del a
        self.losses += list(b.history)
        self.state3 = b.state
        self.h.log(f"steps 2-3: losses {b.history}")

    def _loop(self, state, seed, iterations, callbacks=None):
        from event3dgs_tpu_torch.train.loop import TrainCallbacks, train_loop

        callbacks = callbacks or TrainCallbacks(
            on_metrics=self._on_setup, log_every=int(self.wl["log_every"]))
        return train_loop(state, self.data, self._train_config(seed),
                          self.mode, self.extent, iterations=iterations,
                          callbacks=callbacks)

    def _on_setup(self, it, metrics):
        if "graph_capture_ms" in metrics:
            self.captures.append(float(metrics["graph_capture_ms"]))

    # --- the window ----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        from event3dgs_tpu_torch.train.loop import TrainCallbacks

        warmup, tracer = int(self.wl["warmup"]), self.h.tracer
        marks, ticks = {}, []

        def on_metrics(it, metrics):
            if "graph_capture_ms" in metrics:
                self.captures.append(float(metrics["graph_capture_ms"]))
                if "open" not in marks:
                    self.window_capture = self.captures[-1]
            if "loss" not in metrics:
                return
            if "open" not in marks:
                if it >= warmup:
                    tracer.start()
                    marks["open"] = (time.perf_counter(), it)
                return
            now = time.perf_counter()
            ticks.append((now, it))
            if now - marks["open"][0] >= seconds:
                tracer.stop()
                marks["close"] = (now, it)
                raise WindowClosed

        try:
            self._loop(self.state3, self.seeds[2], WINDOW_ITERATIONS,
                       TrainCallbacks(on_metrics=on_metrics,
                                      log_every=int(self.wl["log_every"])))
        except WindowClosed as closed:
            self.closing = closing_params(closed.__traceback__)
        (t0, it0), (t1, it1) = marks["open"], marks["close"]
        rates = [round((b[1] - a[1]) / (b[0] - a[0]), 2)
                 for a, b in zip([marks["open"]] + ticks, ticks)]
        self.h.log(f"it/s between log ticks: {rates}; captures {self.captures}")
        self.it_open, self.it_close = it0, it1
        self.units = it1 - it0
        return {"train_it_s": (it1 - it0) / (t1 - t0)}

    def release(self):
        """Free what the program holds but the state the check reads; the
        parameters where the window closed move to the host."""
        self.data = None
        if self.closing is not None:
            self.closing = {k: v.to("cpu", copy=True) for k, v in self.closing.items()}
        gc.collect()
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    # --- what the reference checks -------------------------------------------

    def _picks(self, seed: int, n: int) -> list:
        rng = random.Random(seed)
        views = int(self.cfg["trajectory"]["views"])
        return [pick_view(rng, views, self.mode) for _ in range(n)]

    def _program_readings(self, raw0, moments0):
        """The program's readings: first-gradient norms from its moments
        after one step; after three, the change norms of the parameters
        and statistics and the norms of nu₃ − β₂³·nu₀."""
        dev = self.h.device
        f64 = lambda t: t.to(dev, torch.float64)
        g1 = {k: float(torch.linalg.norm((f64(self.mu1[k]) - ref.B1 * f64(moments0[k][0]))
                                         / (1.0 - ref.B1)))
              for k in self.mu1}
        s = self.state3
        p3 = {k: getattr(s.params, k) for k in ref.LEAVES}
        change = {k: float(torch.linalg.norm(f64(p3[k]) - f64(raw0[k])))
                  for k in ref.LEAVES}
        if self.mode == "event":
            change["contrast"] = abs(float(s.contrast) - float(self.cfg["contrast_init"]))
        for k in STATS:
            change[k] = float(torch.linalg.norm(f64(getattr(s.stats, k))))
        nu3 = dict(s.opt_state.nu, contrast=s.contrast_opt.nu)
        moment = {k: float(torch.linalg.norm(f64(nu3[k]) - DECAY3 * f64(moments0[k][1])))
                  for k in nu3}
        return g1, change, moment

    def _reference(self, raw0, moments0, dtype=torch.float32, half=False):
        """The reference's losses, first gradient norms and change norms
        over the first three steps from the same start."""
        dev = self.h.device
        scene = self._scene()
        n = raw0["xyz"].shape[0]
        zeros = lambda: torch.zeros(n, device=dev)
        c_mu, c_nu = moments0["contrast"]
        st = ref.State(params=dict(raw0),
                       mu={k: moments0[k][0] for k in ref.LEAVES},
                       nu={k: moments0[k][1] for k in ref.LEAVES},
                       count=self.start,
                       stats={k: zeros() for k in STATS},
                       contrast=torch.tensor(float(self.cfg["contrast_init"]), device=dev),
                       c_mu=c_mu, c_nu=c_nu)
        picks = self._picks(self.seeds[0], 1) + self._picks(self.seeds[1], 2)
        bg = torch.zeros(3, device=dev)
        losses, g1 = [], None
        for k, idx in enumerate(picks):
            st, loss, grads, _ = ref.step(st, self.mode, scene, idx, bg,
                                          self.start + k + 1, self.extent,
                                          dtype, half)
            losses.append(float(loss))
            if g1 is None:
                g1 = {name: float(torch.linalg.norm(g.double()))
                      for name, g in grads.items()}
        change = {k: float(torch.linalg.norm(st.params[k].double() - raw0[k].double()))
                  for k in ref.LEAVES}
        nu3 = dict(st.nu)
        if self.mode == "event":
            change["contrast"] = abs(float(st.contrast) - float(self.cfg["contrast_init"]))
            nu3["contrast"] = st.c_nu
        for k in STATS:
            change[k] = float(torch.linalg.norm(st.stats[k].double()))
        moment = {k: float(torch.linalg.norm(v.double() - DECAY3 * moments0[k][1].double()))
                  for k, v in nu3.items()}
        return losses, g1, change, moment

    def check(self) -> list:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        raw0, moments0 = self._initial()
        prog = (self.losses, *self._program_readings(raw0, moments0))
        self.state3 = None
        gc.collect()
        refs = self._reference(raw0, moments0)
        for what, p, r in zip(("loss", "grad1", "change3", "nu3"), prog, refs):
            if isinstance(p, list):
                p, r = dict(enumerate(p)), dict(enumerate(r))
            self.h.log(f"{what}: " + ", ".join(f"{k} {p[k]!r} / {r[k]!r}" for k in r))
        return self.numbers(prog, refs)

    def control(self, dtype=torch.bfloat16, half: bool = False) -> list:
        """The numbers of the reference put in the program's place, in
        ``dtype`` (the control) or with the loss over half the pixels (a
        fault), against the reference."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        raw0, moments0 = self._initial()
        r = self._reference(raw0, moments0)
        c = self._reference(raw0, moments0, dtype, half)
        return self.numbers(c, r)

    def numbers(self, prog, refs) -> list:
        """The numbers compared: each step's loss; by the worst leaf, the
        first gradient's norm, the change of the parameters (with the
        contrast and the densify statistics) over the three steps and the
        squared gradients Adam's second moments took in, of the leaves the
        reference's gradient moves."""
        (losses_p, g1_p, change_p, nu_p), (losses_r, g1_r, change_r, nu_r) = prog, refs
        lim = self.wl["limits"]
        moved = moved_leaves(g1_r)
        return [Check("loss_gap", relative_gap(losses_p, losses_r), lim["loss_gap"]),
                Check("grad_gap", leaf_gap(g1_p, g1_r, list(g1_r))[0], lim["grad_gap"]),
                Check("change_gap", leaf_gap(change_p, change_r, moved + list(STATS))[0],
                      lim["change_gap"]),
                Check("moment_gap", leaf_gap(nu_p, nu_r, moved)[0], lim["moment_gap"])]

    # --- the traced run's work counts ----------------------------------------

    def poses(self, idx: int) -> list:
        """The poses a step at view ``idx`` renders."""
        return [idx, idx, idx + 1] if self.mode == "event" else [idx]

    @torch.no_grad()
    def work(self) -> dict:
        """Work of a step averaged over the window's steps at their own
        views, the pairs counted by the reference at the parameters where
        the window closed (once per pose)."""
        raw = self.closing
        if raw is None:
            self.h.log("no state at the window's close: counted at the initial parameters")
            raw = self._initial()[0]
        raw = {k: v.to(self.h.device) for k, v in raw.items()}
        views = recipes.views(self.cfg, self.h.device)
        steps = self._picks(self.seeds[2], self.it_close)[self.it_open:]
        means, feats, opac, scales, rots = splats.activated(raw)
        pairs = {}
        for i in sorted({p for idx in steps for p in self.poses(idx)}):
            cam = splats.camera(views, i)
            p = splats.project(means, scales, rots, opac, cam)
            f = splats.features(p, splats.sh_colors(feats, means, cam.center), opac)
            tl = splats.tile_lists(p, opac, cam.width, cam.height)
            pairs[i] = splats.pair_counts(f, tl, cam.width, cam.height)
        self.h.log(f"pairs counted at {len(pairs)} poses")
        n = raw["xyz"].shape[0]
        total = {}
        for idx in steps:
            step = work.train_step(self.mode, n, int(self.cfg["sh_degree"]),
                                   [pairs[i] for i in self.poses(idx)],
                                   int(self.cfg["width"]), int(self.cfg["height"]))
            for k, v in step.items():
                total[k] = total.get(k, 0.0) + v
        per_render = len(self.poses(0))
        return {"units": self.units,
                "least_ms": {k: v / len(steps) for k, v in total.items()},
                "launches": {"K1": per_render, "K2": per_render, "Adam": 1},
                "counters": {"capture_ms": self.window_capture}}
