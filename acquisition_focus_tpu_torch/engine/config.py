"""The port's own copy of the JAX package's ``engine/config.py`` (plain Python;
tests hold ``DEFAULTS`` and ``load_config`` equal to the original), so one JSON
config drives both packages.

Layered plain-dict config system, JSON-compatible with the reference's
config_dict.json keys (documented at reference README.md:59-133) plus TPU-specific
extensions. Merge order: defaults <- base json <- meta json <- stage overlay
(reference main_acquisition_focus.py:111-124, stages.py:15-32).
"""

import json
from pathlib import Path


class DotDict(dict):
    """dict with attribute access (reference python_utils.py:9-21)."""
    __getattr__ = dict.get

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        del self[k]

    def copy(self):
        return DotDict(dict.copy(self))


DEFAULTS = DotDict(
    # — reference-compatible keys (config_dict.json:1-73) —
    num_folds=3,
    fold_override=0,
    epochs=80,
    test_only_and_output_to=None,
    batch_size=2,
    num_grad_accum_steps=2,
    val_batch_size=1,
    do_augment_input_orientation=True,
    do_augment_recon_orientation=False,
    aug_phases=["train", "val"],
    sample_augment_strength=1.0,
    use_affine_theta=True,
    base_views=["p2CH", "p2CH", "p2CH"],
    offset_clip_value=0.2,
    zoom_clip_value=0.0,
    affine_theta_optim_method="R6-vector",
    view_optimization_mode="opt-all",
    use_binarized_labels=False,
    dataset=["mmwhs", "./data/datasets/MMWHS/prepared_files"],
    hires_fov_mm=[192.0, 192.0, 192.0],
    hires_fov_vox=[128, 128, 128],
    slice_fov_mm=[192.0, 192.0, 1.5],
    slice_fov_vox=[128, 128, 1],
    prescan_fov_mm=[192.0, 192.0, 192.0],
    prescan_fov_vox=[128, 128, 128],
    clinical_view_affine_type="from-gt",
    label_slice_type="from-gt",
    optimize_lv_only=False,
    rotate_slice_to_min_principle=False,
    lr=0.001,
    use_scheduling=True,
    model_type="hybrid-unet",
    save_every="best",
    mdl_save_prefix="data/models",
    debug=False,
    wandb_mode="disabled",
    sweep_type="stage-sweep",
    stage_override=None,
    model_checkpoint_path=None,
    transform_model_checkpoint_path=None,
    do_output=True,
    device="tpu",
    use_autocast=False,
    use_caching=True,
    # — TPU-native extensions —
    compute_dtype="bfloat16",        # conv compute dtype; params stay float32
    atm_remat=False,                 # True: fully recompute ATM conv chains in bwd
    unet_remat=False,                # True: fully recompute U-Net skip/decoder stages
                                     # (False = policy remat: save bf16 conv outs only)
    decoder_save_names=["conv_out", "conv_in0"],  # decoder remat saves (the JAX
                                     # package's recompute policy; the port's in
                                     # models/recompute.py, PARITY.md)
    use_pallas_conv3d='fwd',         # hand-written conv on the full-res decoder
                                     # level: False | 'fwd' | 'fwdN' | 'wg' | 'dx' |
                                     # 'full' (models/hybrid_unet.py)
    theta_refresh_every=1,           # theta-refresh cadence k: locnets run+train
                                     # per step only every k-th epoch; between
                                     # refreshes each sample's theta is a cached
                                     # constant (exact while the transform params
                                     # are frozen). 1 = reference behavior
                                     # (recompute per step). k>1 is a RECIPE change
                                     # (transform updates at 1/k cadence, thetas
                                     # blind to the augmentation draw).
    mesh_shape=None,                 # e.g. {"data": 8}; None = single device
    stop_at_epoch=None,              # pause a run early; schedules still span `epochs`
    base_features=None,              # U-Net width plan override (None = reference)
    locnet_width=None,               # localization-net width (None = reference 32)
    num_sa_slices=15,                # SA stack size in view-affine precompute
    metrics_every=20,                # heavy-metric cadence (reference run_dl.py:507)
    seed=0,
    log_dir="data/runs",
    debug_nans=False,                # jax_debug_nans anomaly detection
    segment_model_path=None,         # torch.save ckpt for from-segmented modes
    min_prescan_dice=0.5,            # from-segmented build gates: abort when the
    max_prescan_hd95_mm=12.0,        # segmented prescan vs GT is worse than this
                                     # (reference oracle lands at ~0.805 Dice;
                                     # the phantom floor is lower because its
                                     # segmenter trains for minutes, not hours)
    segment_extra_permute=True,      # MMWHS output transpose (reference nnU-Net
                                     # axis workaround); False for in-framework ckpts
    centroid_ref_path=None,          # canonical heart label NIfTI (phantom default)
)


# The port's own keys, which the JAX package does not know: read as
# ``config.get(key, PORT_DEFAULTS[key])``, so that ``DEFAULTS`` stays the
# original's.
PORT_DEFAULTS = DotDict(
    trace_spans=False,               # record the training step's spans in memory
                                     # and log their host ms per step each epoch
                                     # (utils/spans.py, engine/runner.py)
)


def load_config(base_path=None, meta_path=None, overrides=None):
    """Build an effective config: DEFAULTS <- base json <- meta json <- overrides."""
    cfg = DotDict(DEFAULTS.copy())
    for path in (base_path, meta_path):
        if path:
            with open(Path(path)) as f:
                cfg.update(json.load(f))
    if overrides:
        cfg.update(overrides)
    return cfg
