"""The port's CLI (torch port of the JAX package's ``main.py``): config merge, fold
construction, dataset build/caching, and the per-fold stage sweep over the port's
own copy of the stage machinery (``engine/stages.py``).

    python -m acquisition_focus_tpu_torch.main --meta_config_path <meta.json> \
        [--config_path <base.json>] [--base_dir <dir>] [--device cpu]

Same config keys and run flow as the JAX package's CLI: the meta JSON overrides
the base config; ``sweep_type`` 'stage-sweep' runs opt_view{i} -> ref per fold.
Everything runs on the card unless the caller asks for the CPU.

A config with a ``mesh_shape`` of n > 1 devices runs in n processes: the CLI
builds the datasets once, then starts one rank per GPU joined by NCCL (with
``--device cpu``: n ranks on the CPU joined by gloo) on a free localhost port, and
every rank trains on those same datasets. Started under torchrun (``WORLD_SIZE``
set) or with a process group already initialized, the run joins that group
instead: rank 0 builds the datasets and sends them to the others.
"""

import argparse
import json
import os
from datetime import datetime
from pathlib import Path

import torch
import torch.distributed as dist

from acquisition_focus_tpu_torch.data.cache import load_or_build
from acquisition_focus_tpu_torch.data.mrxcat import get_dataset_class
from acquisition_focus_tpu_torch.engine.checkpoint import checkpoint_exists
from acquisition_focus_tpu_torch.engine.config import DotDict, load_config
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch.engine.stages import get_std_stages, merge_stage_config
from acquisition_focus_tpu_torch.engine.train import resolve_device
from acquisition_focus_tpu_torch.parallel.mesh import (
    is_main_process, mesh_processes, spawn_ranks)
from acquisition_focus_tpu_torch.utils.logging import get_fold_postfix

__all__ = ['build_fold_iter', 'get_std_stages', 'main', 'stage_sweep_run']


def build_fold_iter(config, training_dataset):
    """[(fold index, (train case indices, val case indices))] from
    data_split.json; ``fold_override`` keeps one fold."""
    if config['num_folds'] < 1:
        return [(-1, (list(range(len(training_dataset))), []))]

    fold_iter = []
    split = training_dataset.data_split
    for fold_idx in range(config['num_folds']):
        fold = split['train_folds'][f'fold_{fold_idx}']
        train_files = [split['train_files'][i] for i in fold['train_idxs']]
        val_files = [split['train_files'][i] for i in fold['val_idxs']]
        train_ids = {training_dataset.extract_3d_id(
            training_dataset.get_file_id(f)[0]) for f in train_files}
        val_ids = {training_dataset.extract_3d_id(
            training_dataset.get_file_id(f)[0]) for f in val_files}
        overlap = train_ids & val_ids
        if overlap:
            raise ValueError(f"Train and val sets overlap: {overlap}")
        train_idxs = [i for i in training_dataset.switch_3d_identifiers(
            sorted(train_ids)) if i is not None]
        val_idxs = [i for i in training_dataset.switch_3d_identifiers(
            sorted(val_ids)) if i is not None]
        fold_iter.append((fold_idx, (train_idxs, val_idxs)))

    if config.get('fold_override') is not None:
        k = config['fold_override']
        fold_iter = fold_iter[k:k + 1]
    return fold_iter


def _load_sweep_state(path):
    p = Path(path)
    if p.exists():
        return json.loads(p.read_text())
    return {'completed': {}, 'in_progress': None}


def _save_sweep_state(path, state):
    if not is_main_process():
        return
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(state, indent=2))


def stage_sweep_run(base_dir, run_name, config, fold_properties, stages,
                    training_dataset, test_dataset, run_test_once_only, *, device='cuda'):
    """Per-fold stage sweep: each stage of ``stages`` (``get_std_stages``) runs
    ``run_dl`` on its merged config; the runner writes the stage's best
    ``save_path`` back, and the next ``opt_view`` stage loads it as its
    ``transform_model_checkpoint_path``.

    With ``sweep_state_path`` set, the sweep resumes at stage granularity:
    completed stages are recorded (with their ``save_path``, so chaining survives
    a relaunch) and skipped; a stage interrupted mid-training resumes from its
    own best checkpoint through the runner's full-state restore. A completed
    stage's record also holds the ``transform_model_checkpoint_path`` it loaded
    (a key the JAX package's sweep state does not have, and does not read).

    ``device``: where every stage's run lives (``run_dl``'s ``device``); the card
    unless the caller asks for ``'cpu'``.

    In a process group (a mesh run) every rank runs the sweep; rank 0 alone writes
    the sweep state, and every rank has read it before any write. The next
    stage's checkpoint is on disk before any rank goes on (``run_dl`` saves with
    a barrier)."""
    state_path = config.get('sweep_state_path')
    fold_key = f"fold-{fold_properties[0]}"
    state = _load_sweep_state(state_path) if state_path else None
    if dist.is_initialized():
        dist.barrier()

    for stage in stages:
        stage_id = stages.current_key
        stage_key = f"{fold_key}/{stage_id}"

        if state is not None and stage_key in state['completed']:
            # completed in a previous launch: hand its recorded save forward so
            # chaining into the next stage works
            rec = state['completed'][stage_key]
            if rec.get('save_path'):
                stage['save_path'] = rec['save_path']
            stage.activate()
            print(f"Skipping completed stage {stage_key} "
                  f"(save_path={rec.get('save_path')})")
            continue

        stage.activate()
        stage_config = merge_stage_config(DotDict(config.copy()), stage)
        stage_run_name = f"{run_name}_stage-{stage_id}"

        if state is not None:
            prog = state.get('in_progress')
            if prog and prog.get('stage_key') == stage_key:
                # interrupted mid-stage: resume from that launch's best save
                prev_best = Path(base_dir) / config['mdl_save_prefix'] / \
                    f"{prog['run_name']}_best"
                if checkpoint_exists(str(prev_best)):
                    stage_config['model_checkpoint_path'] = str(prev_best)
                    stage_run_name = prog['run_name']  # keep one metric stream
                    print(f"Resuming interrupted stage {stage_key} from {prev_best}")
            state['in_progress'] = {'stage_key': stage_key, 'run_name': stage_run_name}
            _save_sweep_state(state_path, state)

        print(f"Running {stage_run_name}")
        run_dl(base_dir, stage_config, fold_properties, stage=stage,
               training_dataset=training_dataset, test_dataset=test_dataset,
               run_test_once_only=run_test_once_only, run_name=stage_run_name,
               device=device)

        if state is not None:
            state['completed'][stage_key] = {
                'save_path': stage.get('save_path'), 'run_name': stage_run_name,
                'transform_model_checkpoint_path': stage_config.get(
                    'transform_model_checkpoint_path')}
            state['in_progress'] = None
            _save_sweep_state(state_path, state)


def main(argv=None, *, device=None):
    """Build the datasets (or load them from the cache) and run every fold.
    ``device``: where the build and the runs live (``None``: the card, or the
    ``--device`` argument); ``debug_nans`` turns on autograd's anomaly detection.
    A ``mesh_shape`` of n > 1 devices runs on n processes (see the module
    docstring); a mesh that needs more GPUs than exist raises before any build."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--meta_config_path', type=str, default=None)
    parser.add_argument('--config_path', type=str, default=None,
                        help='base config json (defaults to built-in DEFAULTS)')
    parser.add_argument('--base_dir', type=str, default='.')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    config = load_config(args.config_path, args.meta_config_path)
    n = mesh_processes(config.get('mesh_shape'))
    joined = n > 1 and _join_process_group(device)
    if n > 1 and not joined and device.type == 'cuda' and torch.cuda.device_count() < n:
        raise RuntimeError(f"mesh {dict(config['mesh_shape'])} needs {n} GPUs; "
                           f"{torch.cuda.device_count()} exist")

    data = None
    if not joined or is_main_process():
        data = _build_datasets(config, device)
    if joined:
        box = [data]
        dist.broadcast_object_list(box, src=0)
        data = box[0]
    elif n > 1:
        if device.type == 'cuda':
            from acquisition_focus_tpu_torch.ops.kernels import _lib
            _lib.library()           # build the kernels once, before the ranks start
        spawn_ranks(_run_rank, n, args=(args.base_dir, config, data, device.type),
                    backend='nccl' if device.type == 'cuda' else 'gloo',
                    threads=max(1, torch.get_num_threads() // n))
        return
    _run_folds(args.base_dir, config, data, device)


def _join_process_group(device):
    """Join the process group of a torchrun launch (or one already initialized):
    True; False where this process is alone."""
    if not dist.is_initialized():
        if int(os.environ.get('WORLD_SIZE', '1')) <= 1:
            return False
        if device.type == 'cuda':
            torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', '0')))
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo')
    return True


def _build_datasets(config, device):
    """(training dataset, test dataset, fold list, run name), built once."""
    run_test_once_only = bool(config.get('test_only_and_output_to'))
    dataset_name, dataset_dir = config['dataset']
    dataset_cls = get_dataset_class(dataset_name)

    training_dataset = load_or_build(
        dataset_cls, dataset_dir, config,
        state='empty' if run_test_once_only else 'train',
        debug=config.get('debug', False), device=device)
    test_dataset = load_or_build(
        dataset_cls, dataset_dir, config, state='test',
        debug=config.get('debug', False), device=device)
    for ds in (training_dataset, test_dataset):
        ds.segment_fn = None    # the build's segmenter hook; the ranks get the cases

    fold_iter = build_fold_iter(config, training_dataset) \
        if not run_test_once_only else [(0, ([], []))]
    now = datetime.now().strftime('%Y%m%d__%H_%M_%S')
    return training_dataset, test_dataset, fold_iter, f"{now}_{device.type}"


def _run_rank(rank, base_dir, config, data, device_type):
    """One rank of a mesh run started by :func:`main`."""
    device = torch.device('cuda', rank) if device_type == 'cuda' else torch.device('cpu')
    _run_folds(base_dir, config, data, device)


def _run_folds(base_dir, config, data, device):
    """Run every fold of ``data`` (from :func:`_build_datasets`) on ``device``."""
    training_dataset, test_dataset, fold_iter, run_name = data
    run_test_once_only = bool(config.get('test_only_and_output_to'))
    if config.get('debug_nans'):
        torch.autograd.set_detect_anomaly(True)

    for fold_properties in fold_iter:
        fold_run_name = f"{run_name}_{get_fold_postfix(fold_properties)}"
        if config.get('sweep_type') is None:
            run_dl(base_dir, config, fold_properties,
                   training_dataset=training_dataset, test_dataset=test_dataset,
                   run_test_once_only=run_test_once_only, run_name=fold_run_name,
                   device=device)
        elif config['sweep_type'] == 'stage-sweep':
            stage_sweep_run(base_dir, fold_run_name, config, fold_properties,
                            get_std_stages(config), training_dataset, test_dataset,
                            run_test_once_only, device=device)
        else:
            raise ValueError(config['sweep_type'])

        if config.get('debug') or run_test_once_only:
            break


if __name__ == '__main__':
    main()
