"""CLI application: `python -m lightgbm_tpu_torch key=value… [config=train.conf]`.

Port of lightgbm_tpu/application.py (the reference's Application,
application.cpp and main.cpp): parse key=value argv and the config file,
then run the task:

- ``train`` — load the data file and the valid files
  (`Dataset.from_file`: text, binary or the `<data>.bin` cache, one-shot
  or two-round), boost with per-iteration metric lines, checkpoint and
  resume (`checkpoint_path`, `checkpoint_interval`), save the model and
  its `.refbin` frozen-mapper sidecar;
- ``predict`` — score a data file, chunk by chunk, to `output_result`;
- ``serve`` — the JSON-lines HTTP scoring server (serving/server.py);
- ``route`` — the router tier in front of serving backends (router/);
- ``online`` — the refresh daemon (online/trainer.py);
- ``refit`` — refit input_model's leaf values on a labelled data file.

Training and scoring run on the GPU (device_type=cuda, the default) unless
device_type=cpu is given.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from . import log
from .basic import Booster, LightGBMError
from .boosting.gbdt import create_boosting, load_checkpoint
from .config import Config, config_from_params, parse_cli_args
from .dataset import (Dataset as RawDataset, iter_text_chunks,
                      parse_text_file, probe_text_file, read_text_file)


def _label_idx(cfg: Config) -> int:
    """label_column -> column index: a bare index; `name:<col>` is not
    supported for prediction input."""
    if not cfg.label_column:
        return 0
    if cfg.label_column.startswith("name:"):
        raise LightGBMError(
            "label_column=name:<col> requires has_header=true data; "
            "name-based selection is not supported for prediction input")
    try:
        return int(cfg.label_column)
    except ValueError:
        raise LightGBMError(
            f"invalid label_column: {cfg.label_column!r}") from None


class Application:
    def __init__(self, argv: List[str]):
        params = parse_cli_args(argv)
        if not params:
            raise LightGBMError(
                "no parameters given; usage: python -m lightgbm_tpu_torch "
                "config=train.conf [key=value ...]")
        self.params = params
        self.config = config_from_params(params)

    def run(self) -> None:
        cfg = self.config
        from . import telemetry
        # the task is the process role: spans of a trainer, a daemon and
        # a serving fleet sharing one telemetry_path stay apart
        telemetry.set_process(cfg.task)
        # a standalone Prometheus /metrics for roles without an HTTP
        # server of their own; serve and route mount it on theirs
        metrics_srv = None
        if cfg.metrics_port and cfg.task not in ("serve", "serving",
                                                 "route", "router"):
            metrics_srv = telemetry.start_metrics_server(
                cfg.metrics_port, host=cfg.serve_host)
        try:
            if cfg.task == "train":
                self._train()
            elif cfg.task in ("predict", "prediction", "test"):
                self._predict()
            elif cfg.task in ("serve", "serving"):
                self._serve()
            elif cfg.task in ("route", "router"):
                self._route()
            elif cfg.task in ("online", "online_train"):
                self._online()
            elif cfg.task in ("refit", "refit_tree"):
                self._refit()
            else:
                raise LightGBMError(f"unknown task: {cfg.task}")
        finally:
            if metrics_srv is not None:
                metrics_srv.close()

    # ------------------------------------------------------------------
    def _train(self) -> None:
        cfg = self.config
        if not cfg.data:
            raise LightGBMError("no training data: set data=<file>")
        # the world comes up before any device use (the reference's
        # Network::Init at InitTrain, application.cpp:185-197): from a
        # torchrun environment, or num_machines and the machine list
        from .distributed import maybe_init_from_config
        if maybe_init_from_config(cfg):
            import torch.distributed as dist
            log.info(f"initialized a {dist.get_world_size()}-rank world, "
                     f"backend {dist.get_backend()}")
        t0 = time.time()
        train_raw = RawDataset.from_file(cfg.data, cfg)
        if cfg.is_save_binary_file and train_raw.rank_rows is not None:
            # a rank's block would pass for the whole file on a later load
            log.warning("is_save_binary_file: a pre-partitioned rank holds "
                        "only its rows; no binary cache is saved")
        elif cfg.is_save_binary_file and train_raw.source == cfg.data \
                and not RawDataset._is_binary_file(cfg.data):
            train_raw.save_binary(cfg.data + ".bin")
            log.info(f"saved binary dataset cache to {cfg.data}.bin")
        log.info(f"finished loading data in {time.time() - t0:.6f} seconds")
        log.info(f"number of data: {train_raw.num_data}, number of "
                 f"features: {train_raw.num_features}")

        # checkpoint resume: a prior run's snapshot replaces input_model
        # (its trees include whatever input_model seeded that run with)
        resume = (load_checkpoint(cfg.checkpoint_path)
                  if cfg.checkpoint_path else None)
        gbdt = create_boosting(cfg, "" if resume else cfg.input_model)
        from .objectives import create_objective
        objective = create_objective(cfg)
        start_it = 0
        if resume is not None:
            start_it = gbdt.resume_from_checkpoint(resume, train_raw,
                                                   objective)
            log.info(f"resumed from checkpoint {cfg.checkpoint_path}: "
                     f"iteration {start_it}, {gbdt.num_trees} trees")
        else:
            gbdt.reset_training_data(train_raw, objective)
        for i, vpath in enumerate(cfg.valid_data):
            vraw = RawDataset.from_file(vpath, cfg, reference=train_raw)
            gbdt.add_valid(vraw, f"valid_{i + 1}")

        checkpointing = bool(cfg.checkpoint_path
                             and cfg.checkpoint_interval > 0)
        # an early-stopped run already rolled back past its best
        # iteration, and a rerun must not train the dropped tail again
        resumed_early_stop = (resume is not None
                              and resume.get("finished") == "early_stop")
        if resumed_early_stop:
            start_it = cfg.num_iterations
        stopped_early = resumed_early_stop
        start = time.time()
        for it in range(start_it, cfg.num_iterations):
            stop = gbdt.train_one_iter(None, None, False)
            printing = (cfg.verbose >= 1 and cfg.metric_freq > 0
                        and (it + 1) % cfg.metric_freq == 0)
            valid_res = (gbdt.eval_valid()
                         if printing or cfg.early_stopping_round > 0 else [])
            if cfg.early_stopping_round > 0:
                stop = stop or gbdt.eval_and_check_early_stopping(valid_res)
            if printing:
                for name, metric_name, val, _ in (
                        gbdt.eval_train() if cfg.is_training_metric else []):
                    log.info(f"Iteration:{it + 1}, {name} {metric_name} : "
                             f"{val:g}")
                for name, metric_name, val, _ in valid_res:
                    log.info(f"Iteration:{it + 1}, {name} {metric_name} : "
                             f"{val:g}")
            log.info(f"{time.time() - start:.6f} seconds elapsed, finished "
                     f"iteration {it + 1}")
            if checkpointing and (it + 1) % cfg.checkpoint_interval == 0:
                gbdt.save_checkpoint(cfg.checkpoint_path)
            if stop:
                log.info("early stopping")
                stopped_early = True
                break
        if checkpointing:
            # a final snapshot, so that a rerun after completion resumes
            # to a no-op
            gbdt.save_checkpoint(cfg.checkpoint_path, extra={
                "finished": "early_stop" if stopped_early else "complete"})
        gbdt.save_model_to_file(cfg.output_model)
        log.info(f"finished training, model saved to {cfg.output_model}")
        if cfg.serve_quantize != "raw":
            # the frozen mappers beside the model: what serve_quantize=
            # binned (and the online daemon) quantizes requests against
            try:
                train_raw.save_refbin(cfg.output_model + ".refbin")
                log.info("frozen bin mappers saved to "
                         f"{cfg.output_model}.refbin")
            except OSError as e:
                log.warning(f"could not save the refbin sidecar "
                            f"({type(e).__name__}: {e}); binned serving "
                            "of this model will fall back to raw")

    # ------------------------------------------------------------------
    def _predict(self) -> None:
        cfg = self.config
        if not cfg.data:
            raise LightGBMError("no prediction data: set data=<file>")
        if not cfg.input_model:
            raise LightGBMError("no model: set input_model=<file>")
        # one Booster and one predictor runtime for the whole file
        bst = Booster(model_file=cfg.input_model, params=self.params)
        predictor = Predictor(bst, raw_score=cfg.is_predict_raw_score,
                              leaf_index=cfg.is_predict_leaf_index,
                              num_iteration=cfg.num_iteration_predict,
                              predict_kernel=cfg.predict_kernel,
                              serve_quantize=cfg.serve_quantize,
                              refbin=cfg.input_model + ".refbin")
        predictor.predict_file(cfg.data, cfg.output_result,
                               has_header=cfg.has_header,
                               label_idx=_label_idx(cfg))
        log.info(f"finished prediction, results saved to "
                 f"{cfg.output_result}")

    # ------------------------------------------------------------------
    def _serve(self) -> None:
        from .serving.server import serve_from_config
        serve_from_config(self.config)

    # ------------------------------------------------------------------
    def _route(self) -> None:
        """task=route: the router tier in front of M task=serve backends
        (consistent-hash tenant placement, per-backend breakers, fleet
        /stats and /metrics)."""
        from .router import route_from_config
        route_from_config(self.config)

    # ------------------------------------------------------------------
    def _online(self) -> None:
        """task=online: the refresh daemon — tail a labelled-traffic
        JSONL, refit or continue on trigger, publish generations to the
        registry path; with `serve_models`, one daemon a catalog tenant
        over the shared traffic tail."""
        from .online.trainer import OnlineFleet, OnlineTrainer
        if self.config.serve_models:
            OnlineFleet.from_config(self.config).run_forever()
        else:
            OnlineTrainer.from_config(self.config).run_forever()

    # ------------------------------------------------------------------
    def _refit(self) -> None:
        """task=refit (the reference's refit_tree): one-shot refit of
        input_model's leaf values on a labelled data file, saved to
        output_model."""
        cfg = self.config
        if not cfg.data:
            raise LightGBMError("no refit data: set data=<file>")
        if not cfg.input_model:
            raise LightGBMError("no model: set input_model=<file>")
        from .online.refit import refit_gbdt
        ds = RawDataset.from_file(cfg.data, cfg)
        gbdt = create_boosting(cfg, cfg.input_model)
        # a text file (or its .bin cache) is parsed again and routed on
        # its raw values (exact, as Booster.refit); a binary data file
        # and a two-round load keep the binned routing
        leaf = None
        if not (RawDataset._is_binary_file(cfg.data)
                or cfg.use_two_round_loading):
            X = read_text_file(cfg.data, cfg)[0]
            leaf = gbdt.predict_leaf_index(X)
        stats = refit_gbdt(gbdt, ds, leaf_idx=leaf)
        gbdt.save_model_to_file(cfg.output_model)
        log.info(f"refit {stats['trees_refit']} of {stats['trees']} trees "
                 f"on {stats['rows']} rows (decay {stats['decay_rate']:g}); "
                 f"model saved to {cfg.output_model}")


class Predictor:
    """Batch file prediction (the reference's predictor.hpp): parse the
    input file, score every row, write one prediction per line.

    Values and raw scores go through one `serving.PredictorRuntime`, the
    same runtime as task=serve: chunks are padded to power-of-two row
    buckets and reuse its prepared entries.  Leaf indices take the host
    walk."""

    def __init__(self, booster: Booster, raw_score: bool = False,
                 leaf_index: bool = False, num_iteration: int = -1,
                 predict_kernel=None, serve_quantize: str = "raw",
                 refbin=None):
        self.booster = booster
        self.raw_score = raw_score
        self.leaf_index = leaf_index
        self.num_iteration = num_iteration
        self.runtime = None
        if not leaf_index and booster._gbdt.models:
            # a model without trees keeps Booster.predict (its baseline
            # score); serve_quantize's auto/binned/raw policy is the
            # serving runtime's (binned needs the .refbin sidecar)
            from .serving.runtime import resolve_runtime
            self.runtime = resolve_runtime(
                booster, serve_quantize=serve_quantize, refbin=refbin,
                num_iteration=num_iteration, max_batch_rows=262_144,
                predict_kernel=predict_kernel)

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.leaf_index:
            return self.booster.predict(X, num_iteration=self.num_iteration,
                                        pred_leaf=True)
        if self.runtime is not None:
            return self.runtime.predict(
                X, kind="raw" if self.raw_score else "value")
        return self.booster.predict(X, num_iteration=self.num_iteration,
                                    raw_score=self.raw_score)

    def predict_file(self, data_path: str, out_path: str,
                     has_header: bool = False, label_idx: int = 0,
                     chunk_rows: int = 262_144) -> None:
        """Stream a CSV/TSV file through the predictor `chunk_rows` rows
        at a time, so the float64 matrix of the whole file never exists
        (the reference's pipelined reader); LibSVM takes one parse."""
        with open(out_path, "w") as f:
            for X in _iter_predict_chunks(data_path, has_header, label_idx,
                                          chunk_rows):
                preds = self.predict(X)
                if preds.ndim == 1:
                    f.writelines(f"{v:.17g}\n" for v in preds)
                else:
                    f.writelines(
                        "\t".join(f"{v:.17g}" for v in row) + "\n"
                        for row in preds)


def _iter_predict_chunks(data_path: str, has_header: bool, label_idx: int,
                         chunk_rows: int):
    """Yield [chunk, F] float64 feature blocks of a prediction file: CSV
    and TSV in chunks of `chunk_rows` rows (dataset.iter_text_chunks, the
    values of the one-shot parse), LibSVM in one parse."""
    fmt, _ = probe_text_file(data_path, has_header)
    if fmt == "libsvm":
        X, _, _ = parse_text_file(data_path, has_header, label_idx)
        yield X
        return
    for arr in iter_text_chunks(data_path, fmt, has_header, chunk_rows):
        yield np.delete(arr, label_idx, axis=1)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        Application(argv).run()
    except LightGBMError as e:
        print(f"[LightGBM-TPU] [Fatal] {e}", file=sys.stderr)
        return 1
    return 0
