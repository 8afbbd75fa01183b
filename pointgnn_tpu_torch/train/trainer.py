"""The training loop on one card (counterpart of
:mod:`pointgnn_tpu.train.trainer`): the epoch loop, streaming metrics,
summaries, checkpoint and resume.

Each step trains on a batch of ``batch_size`` frames, on device-built
graphs (``"device_graph"`` true, or unset for the NONE-normalization
configs: graph build, label assignment and box encoding inside the step;
per-step graph randomization, each frame's loss combined with the
reference's graph-union endpoint weighting) or on host-built graphs
(``"device_graph": false``, and unset for configs with a normalized MLP:
the provider's workers build each frame's graph, labels and encoded
boxes; the prefetch thread unions the step's frames into one graph
padded to ``capacity`` and copies it to the card; the model runs the
segment path in 16 checkpointed edge chunks, one with batch norms).
Device-built graphs are slab graphs (``"device_graph_slab"`` true or
"auto") or capped edge lists (``false``, which the JAX package freezes
into the train_configs of runs on any backend but a TPU; the segment
path in 16 chunks).  The resolved routing is frozen into the
train_config saved beside every checkpoint.  Batch norms' moving
averages are updated after each optimizer step (decay ``bn_decay``,
0.999 by default).  The epoch bookkeeping is the JAX package's: resume
recomputes the epoch from the restored step, metrics reset per epoch,
and checkpoints (with the frozen configs) are written every
``save_every_epoch`` epochs, at ``max_steps`` and at exit.

Data parallelism runs one process per card
(:mod:`pointgnn_tpu_torch.parallel.mesh`): the reference's ``NUM_GPU x
COPY_PER_GPU`` towers become ``min(requested, available)`` ranks, each
with its own ``Trainer``.  Every rank draws the same shuffle, takes its
``batch_size / n_devices`` frames of each step (rank ``d`` the slice
``[d*F:(d+1)*F]``), and runs the data-parallel step
(:mod:`pointgnn_tpu_torch.parallel.step`).  Rank 0 alone writes
checkpoints and summaries and prints the epoch log; every rank restores
the same checkpoint.  ``train_torch.py`` launches the ranks.
"""

import collections
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from pointgnn_tpu_torch import configs as cfg_mod
from pointgnn_tpu_torch.graph import pad
from pointgnn_tpu_torch.infer import input_feature_dim
from pointgnn_tpu_torch.model import encodings
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import get_model
from pointgnn_tpu_torch.nn import mlp, slab
from pointgnn_tpu_torch.parallel import mesh as mesh_lib
from pointgnn_tpu_torch.parallel import step as step_lib
from pointgnn_tpu_torch.train import checkpoint as ckpt_lib
from pointgnn_tpu_torch.train import device_pipeline as dpipe
from pointgnn_tpu_torch.train import metrics as metrics_lib
from pointgnn_tpu_torch.train import optimizers as opt_lib
from pointgnn_tpu_torch.train import summary
from pointgnn_tpu_torch.train.pipeline import DataProvider, FetchSpec
from pointgnn_tpu_torch.utils import thread_warnings
from pointgnn_tpu_torch.utils.device import resolve_device

LAUNCH_RANKS = (
    "data-parallel training over %d devices (NUM_GPU x COPY_PER_GPU) runs "
    "one process per device: start the ranks with "
    "pointgnn_tpu_torch.parallel.mesh.launch (train_torch.py does), or "
    "pass n_devices=1"
)


def num_ranks(train_config: Dict, device) -> int:
    """How many ranks a run of ``train_config`` on ``device`` takes.

    The reference's NUM_GPU x COPY_PER_GPU towers become min(requested,
    cards visible) ranks, one per card, on ``cuda``; a named card
    (``cuda:1``) or the CPU trains in one process."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return 1
    requested = train_config.get("NUM_GPU", 1) * train_config.get(
        "COPY_PER_GPU", 1
    )
    return min(requested, torch.cuda.device_count())


def _all_norms_none(config: Dict) -> bool:
    """True when every MLP normalization in the layer configs is NONE
    (all seven shipped configs): such configs train on device-built
    graphs unless the train_config says otherwise; the others on
    host-built graphs."""
    for lc in config["model_kwargs"]["layer_configs"]:
        for key, val in lc.get("kwargs", {}).items():
            norm_key = (
                key == "normalization_type"
                or key.endswith("_normalization_type")
            )
            if norm_key and val != "NONE":
                return False
    return True


def _load_opt_state(fresh, saved):
    """Load a restored optimizer-state tree into the freshly initialized
    one (the torch optimizers keep their parameter references)."""
    for key, val in saved.items():
        cur = fresh[key]
        if isinstance(cur, torch.optim.Optimizer):
            cur.load_state_dict(val)
        elif isinstance(cur, dict):
            _load_opt_state(cur, val)
        elif isinstance(cur, list):
            with torch.no_grad():
                for dst, src in zip(cur, val):
                    dst.copy_(src)
        else:
            fresh[key] = val


class _Profile:
    """A ``torch.profiler`` trace of a window of steps, written to
    ``<profile_dir>/trace.json``."""

    def __init__(self, profile_dir: str, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile_dir = profile_dir
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        self.prof.export_chrome_trace(
            os.path.join(self.profile_dir, "trace.json"))


class Trainer:
    def __init__(
        self,
        config: Dict,
        train_config: Dict,
        fetch_spec: FetchSpec,
        num_frames: int,
        capacity: Optional[pad.GraphCapacity] = None,
        n_devices: Optional[int] = None,
        seed: int = 0,
        device=None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        if mesh is None:
            self.device = resolve_device(device)
            if n_devices is None:
                n_devices = num_ranks(train_config, self.device)
            if n_devices > 1:
                if not dist.is_initialized():
                    raise ValueError(LAUNCH_RANKS % n_devices)
                mesh = mesh_lib.make_mesh(n_devices)
        if mesh is not None:
            self.device = mesh.device
            n_devices = mesh.size
        self.mesh = mesh
        self.n_devices = max(n_devices, 1)
        self.is_chief = mesh is None or mesh.rank == 0
        self.batch_size = train_config.get("batch_size", 1)
        if self.batch_size % self.n_devices:
            raise ValueError("batch_size %d must divide over %d devices"
                             % (self.batch_size, self.n_devices))
        self.frames_per_device = self.batch_size // self.n_devices
        self.config = config
        self.train_config = train_config
        self.num_frames = num_frames
        enc_len = encodings.get_encoding_len(config["box_encoding_method"])
        # an explicit train_config value wins; unset, NONE-normalization
        # configs route to the device graph, the others to host graphs
        dg = train_config.get("device_graph")
        if dg is None:
            dg = _all_norms_none(config)
            if dg and self.is_chief:
                print(
                    "device_graph training auto-enabled (NONE-"
                    "normalization config): graph construction + label "
                    "assignment + box encoding run inside the train step"
                )
        self.device_graph = bool(dg)
        self.device_spec = None
        graph_builder = None
        model_extra = {}
        if self.device_graph:
            dspec, model_extra = dpipe.resolve_device_setup(
                config,
                spec=train_config.get("device_graph_spec"),
                slab=train_config.get("device_graph_slab", "auto"),
            )
            self.device_spec = dspec
            # freeze the resolved setup into the train_config saved
            # beside every checkpoint, so a restart or an evaluator reads
            # the graphs this run trained on instead of resolving them
            # again
            self.train_config = dict(train_config)
            self.train_config["device_graph"] = True
            self.train_config["device_graph_slab"] = bool(dspec.slab_level1)
            self.train_config["device_graph_spec"] = dspec
            fetch_spec = fetch_spec._replace(device_spec=dspec)
        else:
            fetch_spec = fetch_spec._replace(device_spec=None)
        self.model = get_model(config["model_name"])(
            num_classes=config["num_classes"],
            box_encoding_len=enc_len,
            mode="train",
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
        self.capacity = capacity

        self.optimizer, self.lr_schedule = opt_lib.build_from_train_config(
            train_config
        )
        # per-step graph randomization: the device counterpart of the
        # reference's add_rnd3d grid shift and random point per voxel at
        # every fetch; without it every epoch trains on one frozen graph
        # per frame
        graph_rnd = self.device_graph and train_config.get(
            "device_graph_rnd3d",
            config["graph_gen_kwargs"].get("add_rnd3d", True),
        )
        self.step_fn = step_lib.make_train_step(
            self.model,
            self.optimizer,
            loss_config(config),
            graph_builder,
            frames_per_device=(self.frames_per_device if self.device_graph
                               else 1),
            with_metrics=True,
            graph_rng_seed=seed if graph_rnd else None,
            bn_decay=train_config.get("bn_decay", 0.999),
            mesh=mesh,
            unify_copies=train_config.get("unify_copies", True),
        )
        params = self.model.init(
            seed, input_feature_dim(config["input_features"]), self.device
        )
        # the batch norms' moving averages are updated by the step, not
        # by the optimizer
        for key, t in mlp.named_leaves(params):
            t.requires_grad_(key not in mlp.EMA_KEYS)
        self.state = step_lib.init_train_state(params, self.optimizer)
        self.metrics = metrics_lib.StreamingMetrics(
            config["num_classes"], enc_len
        )
        load_to_mem = train_config.get("load_dataset_to_mem", True)
        num_workers = train_config.get("num_load_dataset_workers", 0)
        self.provider = DataProvider(
            fetch_spec,
            load_dataset_to_mem=load_to_mem,
            load_dataset_every_N_time=train_config.get(
                "load_dataset_every_N_time", 1
            ),
            capacity=train_config.get("capacity", 1),
            num_workers=num_workers,
            num_frames=num_frames,
            preload_list=list(range(num_frames))
            if load_to_mem and num_workers > 0 else (),
            # each rank augments its frames with draws of its own
            seed=seed if mesh is None else int(np.random.SeedSequence(
                [seed, mesh.rank]).generate_state(1)[0]),
        )
        self.train_dir = train_config["train_dir"]
        self._rng = np.random.default_rng(seed)
        # per step of train(): host wall time and the part of it the loop
        # waited for its prefetched batch (ms), and the total loss
        self.step_log = {"step_ms": [], "wait_ms": [], "total_loss": []}

    # ------------------------------------------------------------------
    @property
    def global_step(self) -> int:
        return int(self.state.step)

    def restore(self) -> int:
        """Resume from the latest checkpoint in train_dir: the step, the
        parameters and the optimizer state."""
        saved, step = ckpt_lib.restore_checkpoint(self.train_dir,
                                                  device="cpu")
        if saved is None:
            return step
        leaves = opt_lib.param_leaves(self.state.params)
        with torch.no_grad():
            for dst, src in zip(leaves, opt_lib.param_leaves(
                    saved["params"])):
                dst.copy_(src)
        _load_opt_state(self.state.opt_state, saved["opt_state"])
        self.state = self.state._replace(step=int(saved["step"]))
        if self.is_chief:
            print("Restored checkpoint at step %d from %s" % (
                step, self.train_dir
            ))
        return step

    def save(self) -> Optional[str]:
        """Checkpoint the state (rank 0 alone; the other ranks wait for
        it).  Returns the step directory written, None on other ranks."""
        path = None
        if self.is_chief:
            path = ckpt_lib.save_checkpoint(
                self.train_dir,
                self.global_step,
                dict(self.state._asdict()),
                config=self.config,
                train_config=self.train_config,
            )
        if self.mesh is not None:
            mesh_lib.barrier(self.mesh)
        return path

    # ------------------------------------------------------------------
    def prepare_batch(self, frame_indices):
        """Fetch this device's frames of one step and copy them to the
        card: stacked (device graphs) or unioned into one padded graph
        (host graphs; overflow warns and truncates).  Rank ``d`` of a
        mesh takes ``frame_indices[d*F:(d+1)*F]``."""
        if len(frame_indices) != self.batch_size:
            raise ValueError("a step takes %d frames, got %d"
                             % (self.batch_size, len(frame_indices)))
        if self.mesh is not None:
            f = self.frames_per_device
            frame_indices = frame_indices[self.mesh.rank * f:
                                          (self.mesh.rank + 1) * f]
        frames = self.provider.provide_batch(frame_indices)
        if not self.device_graph:
            return pad.to_device(
                pad.batch_and_pad(frames, self.capacity, self._rng),
                self.device)
        return dpipe.frames_to_device(dpipe.stack_frames(frames),
                                      self.device)

    def _prepare_deferred(self, frame_indices):
        """prepare_batch for the prefetch thread: overflow warnings are
        recorded (the warnings module's filters are not thread-safe) and
        returned for the train loop to emit on the main thread."""
        with thread_warnings.deferred() as entries:
            prepared = self.prepare_batch(frame_indices)
        return prepared, entries

    def train_batch(self, frame_indices=None, prepared=None) -> Dict:
        """One optimizer step over batch_size frames."""
        if prepared is None:
            prepared = self.prepare_batch(frame_indices)
        self.state, aux = self.step_fn(self.state, prepared)
        return aux

    def train(
        self,
        max_epoch: Optional[int] = None,
        max_steps: Optional[int] = None,
        log_fn=None,
    ):
        """The training run.

        Steps are pipelined: the loop holds up to
        ``train_config["aux_pipeline_depth"]`` (default 4) steps' aux
        tensors before reading the oldest on the host.  Metrics see every
        step's aux (late), and the NaN guard fires at most ``depth``
        steps after the event (a NaN loss poisons the parameters, so
        every later loss is NaN too).  Depth 0 reads every step at once.
        """
        max_epoch = max_epoch or self.train_config.get("max_epoch", 1)
        max_steps = (
            max_steps
            if max_steps is not None
            else self.train_config.get("max_steps", -1)
        )
        depth = int(self.train_config.get("aux_pipeline_depth", 4))
        # the step count, advanced by the loop as it enqueues steps
        step_no = self.global_step
        # an epoch is floor(num_frames / batch_size) steps: the batch
        # loop drops the tail
        steps_per_epoch = self.num_frames // self.batch_size
        if steps_per_epoch == 0:
            raise ValueError(
                "num_frames=%d < batch_size=%d: an epoch would contain "
                "no batches (shrink batch_size or add frames)"
                % (self.num_frames, self.batch_size)
            )
        start_epoch = step_no // steps_per_epoch
        pending = collections.deque()  # (step_no, device aux)

        def _consume(entry):
            done_step, aux = entry
            total = float(aux["total_loss"])
            if not np.isfinite(total):
                raise FloatingPointError(
                    "non-finite total loss %r at step %d"
                    % (total, done_step)
                )
            self.metrics.update(aux)
            self.step_log["total_loss"].append(total)

        # fetch, stack and copy the NEXT batch on a worker thread while
        # the current step runs; one worker keeps provider and _rng
        # access sequential (deterministic batch contents)
        input_executor = ThreadPoolExecutor(max_workers=1)
        try:
            self._train_epochs(
                input_executor, start_epoch, max_epoch, max_steps,
                depth, step_no, pending, _consume, log_fn,
            )
        finally:
            # joining the in-flight prepare_batch keeps provider and
            # _rng access sequential if the caller trains again
            input_executor.shutdown(wait=True, cancel_futures=True)

    def _train_epochs(
        self, input_executor, start_epoch, max_epoch, max_steps,
        depth, step_no, pending, _consume, log_fn,
    ):
        profile_dir = self.train_config.get("profile_dir")
        profile_start = self.train_config.get("profile_start_step", 10)
        profile_steps = self.train_config.get("profile_steps", 5)
        profile = None
        for epoch_idx in range(start_epoch, max_epoch):
            self.metrics.reset()
            epoch_start = time.time()
            order = self._rng.permutation(self.num_frames)
            starts = list(range(
                0, self.num_frames - self.batch_size + 1, self.batch_size
            ))
            next_input = None
            for pos, batch_idx in enumerate(starts):
                t_step = time.perf_counter()
                if profile_dir and profile is None and self.is_chief and (
                    step_no >= profile_start
                ):
                    profile = _Profile(profile_dir, self.device)
                if next_input is not None:
                    prepared, deferred_warns = next_input.result()
                    # warnings recorded by the prefetch thread fire here,
                    # where callers' filters behave deterministically
                    thread_warnings.emit(deferred_warns)
                else:
                    prepared = self.prepare_batch(
                        order[batch_idx:batch_idx + self.batch_size]
                    )
                wait_ms = (time.perf_counter() - t_step) * 1e3
                if pos + 1 < len(starts):
                    nxt = starts[pos + 1]
                    next_input = input_executor.submit(
                        self._prepare_deferred,
                        order[nxt:nxt + self.batch_size],
                    )
                else:
                    next_input = None
                aux = self.train_batch(prepared=prepared)
                step_no += 1
                pending.append((step_no, aux))
                while len(pending) > depth:
                    _consume(pending.popleft())
                self.step_log["wait_ms"].append(wait_ms)
                self.step_log["step_ms"].append(
                    (time.perf_counter() - t_step) * 1e3)
                if profile is not None and profile_dir and step_no >= (
                    profile_start + profile_steps
                ):
                    profile.stop()
                    profile_dir = None  # one trace per run
                if 0 < max_steps <= step_no:
                    while pending:
                        _consume(pending.popleft())
                    if profile is not None and profile_dir:
                        profile.stop()
                    if self.is_chief:
                        print("save checkpoint at step %d to %s"
                              % (step_no, self.train_dir))
                    self.save()
                    return
            while pending:  # epoch metrics need every step's aux
                _consume(pending.popleft())
            if self.is_chief:
                self._epoch_log(epoch_idx, epoch_start, log_fn)
            if (epoch_idx + 1) % self.train_config.get(
                "save_every_epoch", 20
            ) == 0:
                if self.is_chief:
                    print("save checkpoint at epoch %d to %s"
                          % (epoch_idx, self.train_dir))
                self.save()
        if profile is not None and profile_dir:
            profile.stop()
        self.save()

    def _epoch_log(self, epoch_idx, epoch_start, log_fn):
        """Print the epoch's metrics and write its summaries."""
        lr = float(self.lr_schedule(self.global_step))
        results = self.metrics.print_epoch(
            self.global_step, epoch_idx, lr, time.time() - epoch_start
        )
        for key, value in results.items():
            summary.write_summary_scale(
                key, value, self.global_step, self.train_dir
            )
        summary.write_summary_scale(
            "learning rate", lr, self.global_step, self.train_dir
        )
        if log_fn is not None:
            log_fn(epoch_idx, self.global_step, results)

    def close(self):
        self.provider.close()
        summary.close(self.train_dir)


def run_training(mesh, config, train_config, fetch_spec, num_frames,
                 device=None) -> Dict:
    """``train_torch.py``'s run in one process, or in one rank of a
    launched group (``mesh``): build the ``Trainer``, restore the latest
    checkpoint, train, close.  Returns the launch count of each
    hand-written kernel in this process, the steps run and the
    ``step_log``."""
    wrappers = {"slab_edge_max": slab.slab_edge_max,
                "slab_edge_max_backward": slab.slab_edge_max_backward}
    trainer = Trainer(config, train_config, fetch_spec,
                      num_frames=num_frames, device=device, mesh=mesh)
    try:
        start = trainer.restore()
        before = {k: fn.launches for k, fn in wrappers.items()}
        trainer.train()
    finally:
        trainer.close()
    return {
        "launches": {k: fn.launches - before[k]
                     for k, fn in wrappers.items()},
        "steps": trainer.global_step - start,
        **trainer.step_log,
    }
