"""Train CLI of the port (root ``train.py``: ``--config_json`` plus flat flag
overrides), on one CUDA device, or on the CPU with ``--cpu``:

    python -m joligen_tpu_torch.train --config_json examples/example_ddpm_noglasses2glasses.json \\
        --dataroot datasets/noglasses2glasses_ffhq [--cpu]

What it keeps of the JAX loop: the epoch loop; a feed thread that runs
``prepare_batch`` of batch N+1 while step N runs; loss printing that reads
the loss from the device only every ``output_print_freq`` images; display
inference every ``output_display_freq`` images; ``latest`` / epoch /
``iter_%d`` saves; ``--train_continue`` and ``--train_continue_from``; and a
save of ``latest`` on SIGINT/SIGTERM; for the GANs, the attention masks
among the visuals (``output_display_G_attention_masks``), the D accuracy
every ``train_D_accuracy_every`` images (``train_compute_D_accuracy``) and
f_s's mIoU every ``train_mask_miou_every`` images
(``train_mask_compute_miou``); the train-time metrics
(``train_compute_metrics_test``): a loader at ``test_batch_size`` for each
test set (``data.list_test_sets``, else phase ``test`` unnamed),
``init_metrics`` on the first, ``compute_metrics_test`` of each every
``train_metrics_every`` images and after the last epoch, the final values
in ``<checkpoints_dir>/<name>/eval_results.json``. ``tpu_profile_dir``
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import random
import shutil
import signal
import sys
import threading
import time

from . import resolve_device
from .options import TrainOptions


def _maybe_continue_from(opt):
    """Copy checkpoints from another run dir and record provenance
    (reference train.py:98-120)."""
    src = getattr(opt, "train_continue_from", "") or ""
    if not src:
        return
    dst = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(dst, exist_ok=True)
    copied = []
    for fn in os.listdir(src):
        if "_net_" in fn and fn.startswith("latest"):
            shutil.copy2(os.path.join(src, fn), os.path.join(dst, fn))
            copied.append(fn)
    with open(os.path.join(dst, "finetune_source.json"), "w") as f:
        json.dump({"source": os.path.abspath(src), "files": copied,
                   "date": time.strftime("%c")}, f, indent=2)
    print(f"continuing from {src}: copied {len(copied)} nets")


def _every(batch, freq):
    """The image count between two events of frequency ``freq``, a whole
    number of batches (as the JAX loop counts)."""
    return max(batch, (freq // batch) * batch)


def _feed(model, loader, depth):
    """Yields (prepared batch, host batch): a thread runs
    ``model.prepare_batch`` (host work and the upload) ahead of the step; an
    exception there is raised here."""
    q = queue.Queue(maxsize=max(1, depth))
    done = object()

    def run():
        try:
            for data in loader:
                q.put((model.prepare_batch(data), data))
        except Exception as e:  # raised again in the training thread
            q.put(e)
        finally:
            q.put(done)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, Exception):
            raise item
        yield item


def launch_training(opt, cpu=False, step_callback=None):
    """Train ``opt``'s model; returns it. Runs on CUDA unless ``cpu``.
    ``step_callback(model, total_iters)``, if given, runs after every step
    (``chip_smoke.py`` times synchronized steps with it)."""
    import numpy as np

    resolve_device(cpu=cpu)        # no card and no --cpu: raise before work
    if getattr(opt, "tpu_profile_dir", ""):
        raise NotImplementedError(
            "tpu_profile_dir: traces inside training are not ported; "
            "python -m joligen_tpu_torch.scripts.profile_request --train "
            "traces one training step")

    from .data import create_dataloader, create_dataset, list_test_sets
    from .models import create_model
    from .utils.visualizer import Visualizer

    seed = getattr(opt, "seed", None)
    if seed:
        random.seed(seed)
        np.random.seed(seed)

    dataset = create_dataset(opt, "train")
    dataloader = create_dataloader(opt, dataset)
    opt.steps_per_epoch = max(1, len(dataloader))
    print(f"dataset [{opt.data_dataset_mode}] of size {len(dataset)} created, "
          f"{opt.steps_per_epoch} steps/epoch")

    _maybe_continue_from(opt)
    model = create_model(opt, phase="train", cpu=cpu)
    print("model [%s] created on %s; params: %s" % (
        opt.model_type, model.device,
        {k: f"{v / 1e6:.2f}M" for k, v in model.param_count().items()}))
    visualizer = Visualizer(opt)
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    TrainOptions().save_config(opt, expr_dir)

    if getattr(opt, "train_continue", False):
        load_prefix = ("iter_%d" % opt.train_load_iter
                       if getattr(opt, "train_load_iter", 0) > 0
                       else getattr(opt, "train_epoch", "latest") or "latest")
        try:
            model.load_networks(load_prefix)
            print("resumed from checkpoint")
        except FileNotFoundError:
            print("no checkpoint to resume from; starting fresh")
    elif getattr(opt, "train_continue_from", ""):
        model.load_networks("latest", load_optim=False, strict=False)

    metric_loaders = []
    if getattr(opt, "train_compute_metrics_test", False):
        for name in (list_test_sets(opt.dataroot) or [""]):
            try:
                tds = create_dataset(opt, "test", name=name)
                metric_loaders.append((name, create_dataloader(
                    opt, tds, shuffle=False,
                    batch_size=opt.test_batch_size)))
            except (AssertionError, FileNotFoundError) as e:
                print(f"no test set '{name}': {e}")
        if metric_loaders:
            model.init_metrics(metric_loaders[0][1])

    # save latest on SIGINT/SIGTERM (reference train.py:88-90)
    stop = {"now": False}
    handlers = {s: signal.signal(s, lambda signum, frame: stop.update(now=True))
                for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        return _train_loop(opt, model, dataloader, visualizer, stop,
                           step_callback, metric_loaders)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def _evaluate(model, metric_loaders, results):
    """``compute_metrics_test`` of every test set into ``results`` (keyed
    ``test<name>``), its seconds added to ``model.loop_times``'
    ``metrics_s``; returns ``results``."""
    t0 = time.time()
    for name, loader in metric_loaders:
        results[f"test{name}" if name else "test"] = \
            model.compute_metrics_test(loader)
    model.loop_times["metrics_s"] += time.time() - t0
    return results


def _train_loop(opt, model, dataloader, visualizer, stop, step_callback,
                metric_loaders=()):
    import numpy as np

    batch = opt.train_batch_size
    print_every = _every(batch, opt.output_print_freq)
    save_every = _every(batch, opt.train_save_latest_freq)
    display_freq = getattr(opt, "output_display_freq", 0)
    depth = int(getattr(opt, "tpu_prefetch", 2) or 1)
    metrics_every = _every(batch, int(getattr(opt, "train_metrics_every",
                                              1000) or 1000))
    last_metrics = {}
    total_iters = 0
    t_data, t_compute = 0.0, 0.0
    # seconds the loop has waited for batches, spent in steps and in the
    # train-time metrics
    model.loop_times = {"data_s": 0.0, "compute_s": 0.0, "metrics_s": 0.0}
    last_epoch = opt.train_n_epochs + opt.train_n_epochs_decay
    for epoch in range(getattr(opt, "train_epoch_count", 1), last_epoch + 1):
        epoch_t0 = time.time()
        t_prev = time.time()
        for dev, data in _feed(model, dataloader, depth):
            t0 = time.time()
            t_data += t0 - t_prev
            losses = model.optimize_prepared(dev)
            if step_callback is not None:
                step_callback(model, total_iters + batch)
            t1 = time.time()
            t_compute += t1 - t0
            t_prev = t1
            total_iters += batch
            model.loop_times.update(data_s=t_data, compute_s=t_compute)

            if total_iters % print_every == 0:
                # the one host read of the device loss
                msg = " ".join(f"{k}: {float(v):.4f}"
                               for k, v in losses.items())
                print(f"(epoch: {epoch}, iters: {total_iters}, "
                      f"compute: {t_compute / total_iters:.4f}s/img, "
                      f"data: {t_data / total_iters:.4f}s/img) {msg}",
                      flush=True)
                visualizer.log_losses(epoch, total_iters, losses)

            if display_freq and total_iters % _every(batch,
                                                     display_freq) == 0:
                try:
                    fake = model.inference(data)
                    vis = {"real_A": data["A"], "fake_B": fake,
                           "real_B": data["B"]}
                    if getattr(opt, "output_display_G_attention_masks",
                               False) and hasattr(model,
                                                  "attention_visuals"):
                        vis.update(model.attention_visuals(data))
                    if getattr(opt, "output_display_diff_fake_real", False):
                        vis["diff_real_fake"] = np.abs(
                            np.asarray(fake, np.float32)
                            - np.asarray(data["B"], np.float32)) - 1.0
                    visualizer.save_images(vis, epoch)
                except Exception as e:  # visuals never stop training (JAX)
                    print(f"visuals failed: {e!r}")

            if (getattr(opt, "train_compute_D_accuracy", False)
                    and hasattr(model, "compute_D_accuracy")
                    and total_iters % _every(batch, getattr(
                        opt, "train_D_accuracy_every", 1000)) == 0):
                acc = model.compute_D_accuracy(data)
                print("D accuracy: " + " ".join(
                    f"{k}: {v:.3f}" for k, v in acc.items()), flush=True)
                visualizer.log_metrics(epoch, total_iters, acc)

            if (getattr(opt, "train_mask_compute_miou", False)
                    and hasattr(model, "compute_miou")
                    and total_iters % _every(batch, getattr(
                        opt, "train_mask_miou_every", 1000)) == 0):
                try:  # a diagnostic: never stops training (JAX)
                    miou = model.compute_miou(data)
                    if miou:
                        print("mIoU: " + " ".join(
                            f"{k}: {v:.3f}" for k, v in miou.items()),
                            flush=True)
                        visualizer.log_metrics(epoch, total_iters, miou)
                except Exception as e:
                    print(f"mIoU failed: {e!r}")

            if metric_loaders and total_iters % metrics_every == 0:
                for key, m in _evaluate(model, metric_loaders, {}).items():
                    last_metrics[key] = m
                    print(f"metrics[{key}] " + " ".join(
                        f"{k}: {v:.4f}" for k, v in m.items()), flush=True)
                    visualizer.log_metrics(epoch, total_iters, m)

            if total_iters % save_every == 0:
                model.save_networks("iter_%d" % total_iters
                                    if getattr(opt, "train_save_by_iter",
                                               False) else "latest")
            if stop["now"]:
                print("signal received: saving latest and exiting")
                model.save_networks("latest")
                return model

        if total_iters == 0:
            raise RuntimeError(
                "epoch produced 0 training steps — every sample failed to "
                "load (check dataroot/paths.txt; use --data_relative_paths "
                "for dataroot-relative paths)")
        if epoch < last_epoch:
            # the last epoch's is the save after the loop: the same
            # weights, and the optimizer after its learning-rate update
            model.save_networks("latest")
        if epoch % max(1, opt.train_save_epoch_freq) == 0:
            model.save_networks(str(epoch))
        model.update_learning_rate()
        print(f"end of epoch {epoch} \t time: {time.time() - epoch_t0:.1f}s",
              flush=True)

    model.save_networks("latest")
    if metric_loaders:
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        with open(os.path.join(expr_dir, "eval_results.json"), "w") as f:
            json.dump(_evaluate(model, metric_loaders, last_metrics), f,
                      indent=2)
    return model


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--cpu", action="store_true",
                     help="run on the CPU (default: the CUDA device)")
    ns, rest = pre.parse_known_args(argv)
    opt = TrainOptions().parse_cli(rest)
    launch_training(opt, cpu=ns.cpu)


if __name__ == "__main__":
    main()
