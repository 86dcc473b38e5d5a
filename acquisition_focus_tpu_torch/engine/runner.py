"""Run orchestration (torch port of ``acquisition_focus_tpu/engine/runner.py``):
epoch loops, metric cadence, checkpointing, stage hand-off.

Same config keys, metric names, cadence and files as the JAX runner. The config
(``DEFAULTS``, ``load_config``) and the run logger (``RunLogger``,
``get_global_idx``) are the port's own copies of the JAX package's modules
(``engine/config.py``, ``utils/logging.py``), held equal to them by tests, so one
set of defaults and one JSON config drive both packages.

Random streams: weights come from ``torch.Generator().manual_seed(seed)``; each
training step's augmentation from a generator keyed by (seed, global_idx * 10000
+ step), each evaluation batch's from (seed + 7, global_idx * 10000 + i), and the
shuffle from an epoch-keyed numpy generator, so a resumed run replays the
uninterrupted one exactly. From-segmented runs load the frozen segmenter
(``segment_model_path``) for validation and test; a missing checkpoint warns and
the run goes on without it, as the JAX runner does. Every checkpoint path also
takes the JAX package's orbax directories (``engine/checkpoint.py``).

A ``mesh_shape`` runs the step on a device mesh (``parallel/mesh.py``) in a process
group of one process per device (``main.py`` starts them): the batch split over
'data', the U-Net's features over 'model'. Evaluation batches whose size the
'data' axis does not divide (``val_batch_size=1``), ``theta_pass`` and the heavy
metrics run replicated on every rank; rank 0 alone logs and writes metrics,
artifacts and checkpoints, which keep the one-device format (the slices gathered
to full tensors on save, sliced again on load). Not ported: (E)Pix2Vox under a
mesh, which raises ``NotImplementedError``.
"""

import dataclasses
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from acquisition_focus_tpu_torch.engine.checkpoint import (
    checkpoint_exists, gather_module_state, gather_optimizer_state, load_checkpoint,
    load_optimizer, save_checkpoint)
from acquisition_focus_tpu_torch.engine.config import DEFAULTS, load_config
from acquisition_focus_tpu_torch.engine.metrics import (
    accumulate_label_scores, hausdorff_per_class, hausdorff_per_class_device,
    iou_per_class_labels, reduce_label_scores)
from acquisition_focus_tpu_torch.engine.optimizers import (
    make_epix2vox_optimizer, make_reconstruction_optimizer, make_transform_optimizer)
from acquisition_focus_tpu_torch.engine.train import (
    EPIX2VOX_TYPES, StageSpec, eval_step, init_params, make_models, resolve_device,
    theta_pass, train_step)
from acquisition_focus_tpu_torch.geometry.clinical_views import get_class_volumes
from acquisition_focus_tpu_torch.ops.affine import affine_zooms
from acquisition_focus_tpu_torch.parallel.mesh import (
    barrier, broadcast_scalar, is_main_process, make_mesh, mesh_summary, shard_batch,
    shard_opt_state, shard_params)
from acquisition_focus_tpu_torch.utils.logging import RunLogger, get_global_idx

__all__ = ['DEFAULTS', 'load_config', 'spec_from_config', 'run_dl']


def spec_from_config(config, num_classes, n_active_views, phase='train'):
    """Build the static StageSpec for a phase from the merged stage config."""
    aug_on = phase in config.get('aug_phases', ['train', 'val'])
    return StageSpec(
        n_views=len(config['base_views']),
        num_classes=num_classes,
        n_active_views=n_active_views,
        view_optimization_mode=config['view_optimization_mode'],
        use_affine_theta=config['use_affine_theta'],
        use_binarized_labels=config.get('use_binarized_labels', False),
        optimize_lv_only=config.get('optimize_lv_only', False),
        hires_fov_mm=tuple(config['hires_fov_mm']),
        hires_fov_vox=tuple(config['hires_fov_vox']),
        slice_fov_mm=tuple(config['slice_fov_mm']),
        slice_fov_vox=tuple(config['slice_fov_vox']),
        prescan_fov_mm=tuple(config['prescan_fov_mm']),
        prescan_fov_vox=tuple(config['prescan_fov_vox']),
        optim_method=config['affine_theta_optim_method'],
        offset_clip_value=config['offset_clip_value'],
        zoom_clip_value=config['zoom_clip_value'],
        rotate_slice_to_min_principle=config.get('rotate_slice_to_min_principle', False),
        label_slice_type=config.get('label_slice_type', 'from-gt'),
        augment_input=config.get('do_augment_input_orientation', True) and aug_on,
        augment_recon=config.get('do_augment_recon_orientation', False) and aug_on,
        augment_strength=config.get('sample_augment_strength', 1.0),
        num_grad_accum_steps=config['num_grad_accum_steps'],
        compute_dtype=config.get('compute_dtype', 'bfloat16'),
        model_type=config.get('model_type', 'hybrid-unet'),
        atm_remat=config.get('atm_remat', False),
        unet_remat=config.get('unet_remat', False),
        use_pallas_conv3d=config.get('use_pallas_conv3d', False),
        decoder_save_names=tuple(
            config['decoder_save_names']
            if config.get('decoder_save_names') is not None
            else ('conv_out', 'conv_in0')),
        base_features=tuple(config.get('base_features')
                            or (16, 32, 64, 128, 256, 256)),
        locnet_width=int(config.get('locnet_width') or 32),
    )


def check_ported_config(config):
    """Raise for run options whose code is not ported: (E)Pix2Vox under a device
    mesh (its batch statistics would have to be taken over the global batch,
    ``models/epix2vox.py::BatchNorm``; ``ROADMAP.md`` queue 1)."""
    if config.get('mesh_shape') and config.get('model_type') in EPIX2VOX_TYPES:
        raise NotImplementedError(
            f"not ported yet: model_type={config['model_type']!r} under "
            f"mesh_shape={config['mesh_shape']!r} (see ROADMAP.md, queue 1)")


def n_active_views_for(config):
    if 'n_active_views' in config and config['n_active_views'] is not None:
        return int(config['n_active_views'])
    return len(config['base_views'])


def seeded_generator(seed, index):
    """A CPU ``torch.Generator`` keyed by (seed, index), as the JAX runner folds
    ``index`` into ``jax.random.key(seed)``."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class _NullLogger:
    """The logger of a rank other than 0: logs nothing."""
    dir = None

    def log(self, *args, **kwargs):
        pass

    log_label_metrics = log_oa_metrics = finish = log


def _to_device(batch, device, image=False):
    """numpy batch -> tensors on ``device`` (labels as int64, the rest float32); the
    image volume only with ``image`` (the segmenter's input)."""
    return {k: torch.as_tensor(np.asarray(v),
                               dtype=torch.int64 if k == 'label' else torch.float32,
                               device=device)
            for k, v in batch.items() if image or k != 'image'}


def _load_segmenter(config, num_classes, device):
    """The frozen segmenter of from-segmented runs (label slices replaced by the
    segmented image slices in validation and test), or None: without a configured
    checkpoint, and, with a warning, for a path where none exists."""
    from acquisition_focus_tpu_torch.engine.segmenter import load_segmenter
    path = config.get('segment_model_path')
    if not path or config.get('label_slice_type') != 'from-segmented':
        return None
    segmenter = load_segmenter(path, num_classes, device)
    if segmenter is None:
        print(f"warning: from-segmented configured but no checkpoint at {path}")
    return segmenter


def _heavy_metric_epoch(config, epx):
    return ((epx % config.get('metrics_every', 20) == 0 and epx > 0)
            or (epx + 1 == config['epochs']) or config.get('debug', False)
            or bool(config.get('test_only_and_output_to')))


def run_dl(base_dir, config, fold_properties, stage=None, training_dataset=None,
           test_dataset=None, run_test_once_only=False, run_name='run', device=None):
    """Train one stage on one fold. Returns the best save path (if any).

    ``device``: where the models and batches live; ``None`` is the card, and
    without CUDA only an explicit ``device='cpu'`` runs. Under a ``mesh_shape``
    every rank of the process group calls it; each takes its mesh device."""
    check_ported_config(config)
    mesh = make_mesh(config.get('mesh_shape'))
    device = mesh.device if mesh is not None else resolve_device(device)
    main_rank = mesh is None or is_main_process()
    fold_idx, (train_idxs, val_idxs) = fold_properties
    num_classes = len(training_dataset.label_tags) if training_dataset \
        else len(test_dataset.label_tags)
    n_active = n_active_views_for(config)

    logger = RunLogger(config.get('log_dir', 'data/runs'), run_name,
                       config.get('wandb_mode', 'disabled'), config) if main_rank \
        else _NullLogger()

    specs = {p: spec_from_config(config, num_classes, n_active, p)
             for p in ('train', 'val', 'test')}
    spec = specs['train']
    unet, atms = make_models(spec, device)
    seed = config.get('seed', 0)
    init_params(unet, atms, torch.Generator().manual_seed(seed))

    n_params = sum(p.numel() for p in unet.parameters())
    log = print if main_rank else (lambda *a, **k: None)
    log(f"Reconstruction model params: {n_params / 1e6:.2f}M; "
        f"stage active views: {n_active}/{spec.n_views}")

    # optimizers (fresh per stage)
    B = config['batch_size']
    accum = config['num_grad_accum_steps']
    updates_per_epoch = max(1, len(train_idxs) // (B * accum))
    use_sched = config.get('use_scheduling', True)
    if spec.model_type in EPIX2VOX_TYPES:
        recon_opt = make_epix2vox_optimizer(unet, updates_per_epoch, use_sched)
    else:
        recon_opt = make_reconstruction_optimizer(unet.parameters(), config['lr'],
                                                  updates_per_epoch, use_sched)
    trans_opt = make_transform_optimizer(atms.parameters(), config['lr'], config['epochs'],
                                         updates_per_epoch, use_sched)

    # full-state restore: params, both optimizers and schedules, best-val
    # quality, epoch, so a resumed run continues with the exact LR and moments
    epx_start = 0
    best_quality = float('inf')
    mdl_chk = config.get('model_checkpoint_path')
    if mdl_chk and checkpoint_exists(mdl_chk):
        ck = load_checkpoint(mdl_chk)
        unet.load_state_dict(ck['unet'])
        atms.load_state_dict(ck['atms'])
        # a JAX checkpoint from before the optimizer states were saved has none
        if 'recon_opt' in ck:
            for (opt, sched), module, name in ((recon_opt, unet, 'recon'),
                                               (trans_opt, atms, 'trans')):
                load_optimizer(opt, sched, module, ck[f'{name}_opt'], ck[f'{name}_sched'])
        best_quality = float(ck['best_quality'])
        epx_start = int(ck['epoch']) + 1
        log(f"Loaded checkpoint from {mdl_chk} (resuming at epoch {epx_start})")
    trans_chk = config.get('transform_model_checkpoint_path')
    if trans_chk and checkpoint_exists(trans_chk):
        atms.load_state_dict(load_checkpoint(trans_chk)['atms'])
        log(f"Loaded transform checkpoint from {trans_chk}")

    # the mesh, set up on the restored full state as in the JAX runner: the
    # U-Net's features split over 'model' with AdamW's moments, the ATMs and the
    # transform optimizer replicated
    split = {}
    if mesh is not None:
        if B % mesh.axis_size('data'):
            raise ValueError(f"batch_size {B} must be divisible by the data mesh axis "
                             f"{mesh.axis_size('data')}")
        split = shard_params(unet, atms, mesh)
        shard_opt_state(recon_opt[0], unet, split, mesh)
        log(f"Training on {mesh_summary(mesh)}")

    def put_batch(batch, train, image=False):
        """(batch on the device, its data shard): split over 'data' where the
        batch size divides it, replicated otherwise."""
        shard = None
        if mesh is not None and 'data' in mesh.shape:
            if batch['label'].shape[1 if train else 0] % mesh.axis_size('data') == 0:
                batch = shard_batch(batch, mesh, train)
                shard = (mesh.axis_index('data'), mesh.axis_size('data'))
        return _to_device(batch, device, image), shard

    best_save_path = None

    # theta-refresh cadence (`theta_refresh_every` = k > 1): locnets run and train
    # per step only every k-th epoch; in between, each sample's theta is a cached
    # constant snapshotted by theta_pass after the last update epoch (exact while
    # the transform params are frozen). The cache is derivable state: a resume
    # re-snapshots at its first non-refresh epoch.
    theta_every = int(config.get('theta_refresh_every', 1) or 1)
    use_theta_cache = (theta_every > 1 and spec.use_affine_theta
                       and bool(spec.view_train_mask().any())
                       and not run_test_once_only)
    spec_cached = dataclasses.replace(spec, theta_source='cached') \
        if use_theta_cache else None
    theta_cache = {}

    def refresh_theta_cache():
        for t_sel, t_batch in training_dataset.iterate_eval_batches(train_idxs, 1):
            th = theta_pass(specs['train'], atms, put_batch(t_batch, False)[0])
            theta_cache[t_sel[0]] = th[:, 0].cpu().numpy()   # (A, 4, 4)

    def thetas_for(sel, accum_, B_):
        th = np.stack([theta_cache[sid] for sid in sel])   # (accum*B, A, 4, 4)
        th = th.reshape(accum_, B_, *th.shape[1:])
        return np.ascontiguousarray(th.transpose(0, 2, 1, 3, 4))  # (accum, A, B, 4, 4)

    out_dir = Path(base_dir) / 'data/output' / run_name
    segmenter = _load_segmenter(config, num_classes, device)

    # stop_at_epoch pauses a run early without changing the schedules (functions
    # of the full config['epochs']); a pause checkpoint is force-saved at the stop
    # epoch so that resuming from it continues exactly. 0 means "run no epoch".
    stop_at = config.get('stop_at_epoch')
    stop_epoch = stop_at if stop_at is not None else config['epochs']

    for epx in range(epx_start, stop_epoch):
        global_idx = get_global_idx(fold_idx, epx, config['epochs'])
        logger.log({'ref_epoch_idx': epx}, step=global_idx)
        epoch_t0 = time.time()
        # epoch-keyed shuffling: the same regardless of where the run (re)started
        data_rng = np.random.default_rng((seed + 1) * 1_000_003 + fold_idx * 1009 + epx)

        if not run_test_once_only:
            # ---- train ----
            refresh_epoch = (not use_theta_cache) or (epx % theta_every == 0)
            if use_theta_cache and not refresh_epoch and not theta_cache:
                refresh_theta_cache()   # a resume landed mid-cycle
            step_spec = specs['train'] if refresh_epoch else spec_cached
            unet.train()
            atms.train()
            t_metrics = {}
            losses = []
            n_steps = 0
            for sel, batch in training_dataset.iterate_train_macrobatches(
                    train_idxs, B, accum, data_rng):
                if not refresh_epoch:
                    batch = dict(batch, thetas=thetas_for(sel, accum, B))
                metrics = train_step(step_spec, unet, atms, recon_opt, trans_opt,
                                     put_batch(batch, True)[0],
                                     seeded_generator(seed, global_idx * 10000 + n_steps),
                                     mesh=mesh)
                losses.append(float(metrics['loss']))
                accumulate_label_scores(t_metrics, 'dice', metrics['dice'].cpu().numpy(),
                                        training_dataset.label_tags)
                n_steps += 1
            train_loss = broadcast_scalar(
                float(np.mean(losses)) if losses else float('nan'), mesh)
            _log_phase(logger, config, 'train', train_loss, t_metrics, global_idx)

            if use_theta_cache and refresh_epoch:
                # snapshot thetas for the next k-1 cached epochs (the locnets were
                # last updated by this epoch's final step)
                refresh_theta_cache()

            # ---- val ----
            val_loss = broadcast_scalar(_eval_phase(
                'val', specs['val'], unet, atms, training_dataset, val_idxs, config, logger,
                global_idx, epx, put_batch, mesh, segmenter=segmenter), mesh)
        else:
            train_loss, val_loss = float('nan'), float('nan')

        # ---- test ----
        test_out_dir = config.get('test_only_and_output_to') or None
        _eval_phase('test', specs['test'], unet, atms, test_dataset, None, config, logger,
                    global_idx, epx, put_batch, mesh,
                    out_dir=test_out_dir if main_rank else None, segmenter=segmenter)

        epoch_s = time.time() - epoch_t0
        perf = {'perf/epoch_s': epoch_s}
        if not run_test_once_only:
            perf['perf/train_slices'] = n_steps * accum * B * spec.n_views
        logger.log(perf, step=global_idx)
        log(f"epoch {epx}: train_loss={train_loss:.4f} val_loss={val_loss:.4f} "
            f"({epoch_s:.1f}s)")

        if run_test_once_only:
            break

        # ---- checkpointing: the full training state, best-val quality ----
        quality = val_loss
        save_every = config.get('save_every')
        best_to_save = min(best_quality, quality) if save_every == 'best' else best_quality

        def save(path):
            """Every rank gathers the split state (collectives); rank 0 writes the
            one-device checkpoint; the others wait until it is on disk."""
            state = dict(
                unet=gather_module_state(unet, split, mesh), atms=atms.state_dict(),
                recon_opt=gather_optimizer_state(recon_opt[0], unet, split, mesh),
                recon_sched=recon_opt[1].state_dict(),
                trans_opt=trans_opt[0].state_dict(), trans_sched=trans_opt[1].state_dict(),
                epoch=epx, loss=train_loss, best_quality=best_to_save)
            if main_rank:
                save_checkpoint(path, state)
            barrier(mesh)

        save_path = None
        if save_every == 'best':
            if quality < best_quality:
                best_quality = quality
                save_path = Path(base_dir) / config['mdl_save_prefix'] / f"{run_name}_best"
        elif isinstance(save_every, int) and (
                epx % save_every == 0 or epx + 1 == config['epochs']):
            save_path = Path(base_dir) / config['mdl_save_prefix'] / f"{run_name}_epx{epx}"
        if save_path is not None:
            save(save_path)
            best_save_path = str(save_path)
            if stage is not None:
                stage['save_path'] = str(save_path)

        if epx + 1 == stop_epoch and stop_epoch < config['epochs']:
            # pausing early: force-save the exact stop-epoch state, returned as the
            # resume path; stage chaining still points at the save above
            save_path = Path(base_dir) / config['mdl_save_prefix'] / f"{run_name}_pause"
            save(save_path)
            best_save_path = str(save_path)
            log(f"paused at epoch {epx}; resume with model_checkpoint_path={save_path}")

        if config.get('debug'):
            break

    logger.finish()
    return best_save_path


def _log_phase(logger, config, phase, loss, label_scores, global_idx):
    logger.log({f'losses/{phase}_loss': loss}, step=global_idx)
    (mean_pl, std_pl, mean_oa, std_oa) = reduce_label_scores(label_scores)
    logger.log_label_metrics(f'scores/{phase}_mean', mean_pl, global_idx)
    logger.log_label_metrics(f'scores/{phase}_std', std_pl, global_idx)
    logger.log_oa_metrics(f'scores/{phase}_mean_oa_exclude_bg', mean_oa, global_idx,
                          selected=('dice',))
    logger.log_oa_metrics(f'scores/{phase}_std_oa_exclude_bg', std_oa, global_idx)


def heavy_scores(scores, spec, pred, label, nii_affine, eval_tags):
    """IoU, HD, HD95 (mm, through the norm of the first sample's voxel size) and
    class-volume errors of one evaluation batch, appended to ``scores``. The
    surface distances run on the predictions' device: the torch min-plus EDT on
    a GPU, scipy's EDT for CPU tensors."""
    num_eval = len(eval_tags)
    target = label if not spec.use_binarized_labels else (label > 0).long()
    nifti_zooms = affine_zooms(nii_affine)
    zoom_norm = float(torch.linalg.norm(nifti_zooms[0]))
    accumulate_label_scores(
        scores, 'iou', iou_per_class_labels(pred, target, num_eval).cpu().numpy(), eval_tags)
    if pred.is_cuda:
        hd_hd95 = hausdorff_per_class_device(pred, target, num_eval).cpu().numpy()
        hd, hd95 = hd_hd95[..., 0] * zoom_norm, hd_hd95[..., 1] * zoom_norm
    else:
        p, t = pred.numpy(), target.numpy()
        hd = hausdorff_per_class(p, t, num_eval) * zoom_norm
        hd95 = hausdorff_per_class(p, t, num_eval, percentile=95) * zoom_norm
    accumulate_label_scores(scores, 'hd', hd, eval_tags)
    accumulate_label_scores(scores, 'hd95', hd95, eval_tags)

    vols_p = get_class_volumes(pred, nifti_zooms, num_eval, 'ml').cpu().numpy()
    vols_t = get_class_volumes(target, nifti_zooms, num_eval, 'ml').cpu().numpy()
    diff = np.abs(vols_p - vols_t)
    accumulate_label_scores(scores, 'delta_vol_ml', diff, eval_tags)
    accumulate_label_scores(scores, 'delta_vol_rel', diff / np.maximum(vols_t, 1e-8),
                            eval_tags)


def _eval_phase(phase, spec, unet, atms, dataset, idxs, config, logger, global_idx, epx,
                put_batch, mesh, out_dir=None, segmenter=None):
    """One evaluation pass; ``put_batch(batch, train, image)`` -> (batch on the
    device, its data shard) as the runner places batches. Rank 0 alone (the one
    with a logger directory) writes artifacts."""
    if dataset is None or len(dataset) == 0:
        return float('nan')
    unet.eval()
    atms.eval()
    collect_artifacts = (bool(config.get('do_output')) and phase in ('val', 'test')
                         and logger.dir is not None)
    epx_affines = {}
    epx_inputs = {}
    scores = {}
    losses = []
    heavy = _heavy_metric_epoch(config, epx)
    batch_size = config.get('val_batch_size', 1)
    eval_tags = dataset.label_tags
    with_aug = (phase in config.get('aug_phases', []) and
                config.get('do_augment_input_orientation', False))

    for i, (sel, batch) in enumerate(dataset.iterate_eval_batches(idxs, batch_size)):
        gen = seeded_generator(config.get('seed', 0) + 7, global_idx * 10000 + i)
        batch_t, shard = put_batch(batch, False, segmenter is not None)
        out = eval_step(spec, unet, atms, batch_t, gen, with_aug=with_aug,
                        segmenter=segmenter, mesh=mesh, data_shard=shard)
        if shard is not None:
            batch_t = _to_device(batch, out['pred'].device)
        losses.append(float(out['loss']))
        accumulate_label_scores(scores, 'dice', out['dice'].cpu().numpy(), eval_tags)

        if heavy:
            heavy_scores(scores, spec, out['pred'], batch_t['label'], batch_t['nii_affine'],
                         eval_tags)

        if collect_artifacts:
            for j, case_id in enumerate(sel):
                epx_affines[case_id] = {
                    'grid_affines': out['grid_affines'][:, j].cpu().numpy(),
                    'transformed_nii_affines': out['out_nii_affines'][:, j].cpu().numpy(),
                    'thetas': out['thetas'][:, j].cpu().numpy(),
                }
                epx_inputs[case_id] = out['b_input'][j].float().cpu().numpy().astype(
                    np.float16)

        if out_dir:
            _store_eval_output(out_dir, i, sel, batch, out)
        if config.get('debug'):
            break

    if collect_artifacts and epx_affines:
        _store_epoch_artifacts(logger.dir, phase, epx, epx_affines, epx_inputs,
                               len(config['base_views']))

    loss = float(np.mean(losses)) if losses else float('nan')
    _log_phase(logger, config, phase, loss, scores, global_idx)
    return loss


def _store_epoch_artifacts(run_dir, phase, epx, epx_affines, epx_inputs, n_views):
    """Per-epoch learned-geometry and slice-input artifacts: an affine pickle, a
    PNG mosaic of the inputs and the compact inputs."""
    out_dir = Path(run_dir) / 'output' / phase
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f'affines_{phase}_epx_{epx:05d}.pkl', 'wb') as f:
        pickle.dump(epx_affines, f)
    try:
        # imported here: the plotting stack may be missing where the run trains
        from acquisition_focus_tpu_torch.utils.visualize import (
            save_frameless_image, slice_input_mosaic)
        inputs = np.stack(list(epx_inputs.values())).astype(np.float32)
        mosaic = slice_input_mosaic(inputs, n_views)
        save_frameless_image(mosaic, out_dir / f'slices_{phase}_epx_{epx:05d}.png',
                             cmap='RdPu')
    except Exception as e:  # plotting must never kill training
        print(f'artifact image failed: {e}')
    np.savez_compressed(out_dir / f'input_{phase}_epx_{epx:05d}.npz',
                        **{k: v for k, v in epx_inputs.items()})


def _store_eval_output(out_dir, batch_idx, sel, batch, out):
    """Dump network inputs and outputs of test-only runs."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = dict(
        ids=sel,
        input=out['b_input'].float().cpu().numpy().astype(np.float16),
        pred=out['pred'].cpu().numpy().astype(np.int8),
        target=np.asarray(batch['label'], np.int8),
        thetas=out['thetas'].cpu().numpy(),
        grid_affines=out['grid_affines'].cpu().numpy(),
        out_nii_affines=out['out_nii_affines'].cpu().numpy(),
    )
    with open(out_dir / f'output_batch{batch_idx:05d}.pkl', 'wb') as f:
        pickle.dump(payload, f)
