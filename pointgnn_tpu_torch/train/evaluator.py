"""Checkpoint evaluation (counterpart of
:mod:`pointgnn_tpu.train.evaluator`, the reference's ``eval.py``).

Polls a training directory, evaluates each new checkpoint over the eval
split with the training loss and the streaming metric set, and writes
the scalars to an eval directory (``eval_once`` / ``eval_repeat``: skip
evaluated steps, stop at ``max_step``).  ``device_graph`` resolves as in
the JAX evaluator: "auto" follows the checkpoint's frozen
``train_config``.

On device-built graphs each frame's graph build, label assignment, box
encoding, forward (the slab kernel K1 at both levels, or the segment
path over capped edge lists when the checkpoint trained on them,
``device_graph_slab: false``), loss and metric counts run on the card;
the graph is not randomized, as the reference's eval fetch is not.  On host-built graphs the fetch builds the graph,
labels and encoded boxes; the fetch thread grows ``capacity`` to fit the
frame (never truncating; it prints each growth), pads it and copies it
to the card, which runs the forward on the segment path, the loss and
the metric counts.  ``capacity`` defaults to the family's
``frame_capacity``, with 4x the edges for a checkpoint trained on
device-built graphs (or with ``host_eval_of_device_checkpoint``): those
trained on uncapped neighborhoods.
"""

import collections
import concurrent.futures
import time
from typing import Dict, Optional

import torch

from pointgnn_tpu_torch import configs as cfg_mod
from pointgnn_tpu_torch.graph import pad
from pointgnn_tpu_torch.model import encodings
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import get_model
from pointgnn_tpu_torch.parallel import step as step_lib
from pointgnn_tpu_torch.train import checkpoint as ckpt_lib
from pointgnn_tpu_torch.train import device_pipeline as dpipe
from pointgnn_tpu_torch.train import metrics as metrics_lib
from pointgnn_tpu_torch.train import summary
from pointgnn_tpu_torch.train.pipeline import DataProvider, FetchSpec
from pointgnn_tpu_torch.utils import thread_warnings
from pointgnn_tpu_torch.utils.device import resolve_device

# frames fetched and copied to the card ahead of the step, and steps
# whose metric aux stays on the card before it is read back
PUT_AHEAD = 2
AUX_DEPTH = 4


class Evaluator:
    def __init__(
        self,
        config: Dict,
        eval_config: Dict,
        fetch_spec: FetchSpec,
        num_frames: int,
        capacity: Optional[pad.GraphCapacity] = None,
        train_config: Optional[Dict] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.eval_config = eval_config
        self.num_frames = num_frames
        self.train_config = train_config or {}
        enc_len = encodings.get_encoding_len(config["box_encoding_method"])
        dg = eval_config.get("device_graph", "auto")
        if dg == "auto":
            dg = bool(self.train_config.get("device_graph", False))
        self.device_graph = bool(dg)
        self.device_spec = None
        graph_builder = None
        model_extra = {}
        if self.device_graph:
            # shared with Trainer (resolve_device_setup), so a checkpoint
            # is evaluated on the graphs it trained on; a frozen
            # train_config holds the spec as nested lists, which are
            # coerced back
            dspec, model_extra = dpipe.resolve_device_setup(
                config,
                spec=(eval_config.get("device_graph_spec")
                      or self.train_config.get("device_graph_spec")),
                slab=eval_config.get(
                    "device_graph_slab",
                    self.train_config.get("device_graph_slab", "auto"),
                ),
            )
            self.device_spec = dspec
        self.model = get_model(config["model_name"])(
            num_classes=config["num_classes"],
            box_encoding_len=enc_len,
            mode="eval",
            **model_extra,
            **config["model_kwargs"],
        )
        if self.device_graph:
            graph_builder = dpipe.make_graph_builder(
                self.device_spec, self.model.output_graph_level, config
            )
        if capacity is None:
            capacity = cfg_mod.tpu_settings(config["label_method"])[
                "frame_capacity"]
            if not self.device_graph and (
                self.train_config.get("device_graph")
                or eval_config.get("host_eval_of_device_checkpoint")
            ):
                # a checkpoint trained on uncapped neighborhoods: edge
                # truncation at the training bucket would mis-score it
                capacity = pad.GraphCapacity(
                    vertices=capacity.vertices,
                    edges=tuple(4 * e for e in capacity.edges),
                )
        self.capacity = capacity
        loss_fn = step_lib.make_loss_fn(
            self.model, loss_config(config), with_logits=True
        )
        out_level = self.model.output_graph_level
        num_classes = self.model.num_classes

        @torch.inference_mode()
        def eval_step(params, frame):
            # deterministic graph (no randomization): the reference's
            # eval fetch does not randomize either
            graph = (graph_builder(frame) if graph_builder is not None
                     else frame)
            _, aux = loss_fn(params, graph)
            logits = aux.pop("logits")
            aux.update(metrics_lib.device_updates(
                logits, graph.cls_labels, graph.vertex_mask[out_level],
                num_classes,
            ))
            return aux

        self._eval_step = eval_step
        self.metrics = metrics_lib.StreamingMetrics(
            config["num_classes"], enc_len
        )
        self.provider = DataProvider(
            fetch_spec._replace(is_eval=True, device_spec=self.device_spec),
            load_dataset_to_mem=False,
            num_workers=eval_config.get("num_load_dataset_workers", 0),
            num_frames=num_frames,
        )
        self._evaluated_steps = set()
        self._eval_dirs = set()
        self.frames_per_second = None

    # ------------------------------------------------------------------
    def _put_frame(self, frame_idx):
        """Fetch one frame and copy it to the card (the background
        thread): the packed frame, or the host graph padded to the
        capacity, grown first to fit it.  Capacity warnings are recorded
        for the loop to emit."""
        with thread_warnings.deferred() as entries:
            frame = self.provider.provide(frame_idx)
            if self.device_graph:
                return dpipe.frames_to_device(frame, self.device), entries
            self.capacity, grew = pad.grow_to_fit(self.capacity, [frame])
            if grew:
                print("eval capacity grown to %r" % (self.capacity,))
            return pad.to_device(pad.batch_and_pad([frame], self.capacity),
                                 self.device), entries

    def eval_once(self, train_dir: str, eval_dir: str, step: int) -> Dict:
        """Evaluate checkpoint ``model-<step>`` over the split; returns
        the results dict and writes each scalar to ``eval_dir``."""
        state, _ = ckpt_lib.restore_checkpoint(train_dir, step=step,
                                               device=self.device)
        if state is None:
            raise FileNotFoundError("no checkpoint in %s" % train_dir)
        params = state["params"] if "params" in state else state
        self.metrics.reset()
        t0 = time.time()
        # one thread fetches and copies frame i + PUT_AHEAD while the
        # card runs frame i; a frame's metric aux is read back (a sync)
        # only once AUX_DEPTH later frames are enqueued
        pending = collections.deque()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            puts = collections.deque(
                pool.submit(self._put_frame, i)
                for i in range(min(PUT_AHEAD, self.num_frames))
            )
            next_idx = len(puts)
            while puts:
                frame, entries = puts.popleft().result()
                thread_warnings.emit(entries)
                if next_idx < self.num_frames:
                    puts.append(pool.submit(self._put_frame, next_idx))
                    next_idx += 1
                pending.append(self._eval_step(params, frame))
                while len(pending) > AUX_DEPTH:
                    self.metrics.update(pending.popleft())
        while pending:
            self.metrics.update(pending.popleft())
        elapsed = time.time() - t0
        self.frames_per_second = self.num_frames / max(elapsed, 1e-9)
        print(
            "eval throughput: %.1f frames/s (%d frames in %.1fs)"
            % (self.frames_per_second, self.num_frames, elapsed)
        )
        results = self.metrics.print_epoch(step, 0, 0.0, elapsed)
        for key, value in results.items():
            summary.write_summary_scale(key, value, step, eval_dir)
        self._eval_dirs.add(eval_dir)
        self._evaluated_steps.add(step)
        return results

    def eval_repeat(
        self,
        train_dir: str,
        eval_dir: str,
        eval_every_second: float = 60,
        max_step: int = -1,
        max_polls: Optional[int] = None,
    ):
        """Poll ``train_dir`` for checkpoints not evaluated yet; return
        after evaluating a step at or past ``max_step`` (when positive)
        or after ``max_polls`` polls."""
        polls = 0
        while True:
            steps = ckpt_lib.list_checkpoint_steps(train_dir)
            fresh = [s for s in steps if s not in self._evaluated_steps]
            for step in fresh:
                print("Evaluating checkpoint at step %d" % step)
                self.eval_once(train_dir, eval_dir, step)
                if 0 < max_step <= step:
                    return
            polls += 1
            if max_polls is not None and polls >= max_polls:
                return
            time.sleep(eval_every_second)

    def close(self):
        self.provider.close()
        for eval_dir in self._eval_dirs:
            summary.close(eval_dir)
        self._eval_dirs.clear()
