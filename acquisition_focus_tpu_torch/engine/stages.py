"""The port's own copy of the JAX package's ``engine/stages.py`` (plain Python;
tests hold the stage configs equal to the original's).

Multi-stage view-optimization sweep machinery.

Capability port of the reference stage layer
(the reference's running/stages.py:5-89): one ``opt_view{i}``
stage per base view (optimize the current view, freeze previous ones), then a
final ``ref`` stage with fixed views. Two behaviors matter downstream:

* **Forward key inheritance** — every config key a stage carries (including keys
  the runner writes back into the live stage dict, like ``save_path``) flows
  into the next stage unless that stage overrides it.
* **Checkpoint chaining** — when stage k+1 opens, the previous stage's best
  ``save_path`` is promoted to ``transform_model_checkpoint_path``, freezing
  view k's learned orientation into stage k+1 (reference stages.py:53-54 with
  the write-back at run_dl.py:701-702).

Implemented here as a carry-dict sweep: the sweep owns a single accumulated
key/value state, folded into each stage as it opens. Because inheritance is
transitive, this is behaviorally identical to chained pairwise inheritance.
"""


class Stage(dict):
    """One sweep entry: a dict of config overrides plus an optional ``on_open``
    hook that runs after inheritance (so it can read handed-forward keys)."""

    def __init__(self, on_open=None, **entries):
        super().__init__(**entries)
        self.on_open = on_open

    def activate(self):
        if self.on_open is not None:
            self.on_open(self)


class StageSweep:
    """Iterable over stages with forward key inheritance.

    Exposes ``current_key`` / ``position`` for run naming and progress prints.
    """

    def __init__(self, stages, verbose=False):
        self._pending = list(stages.items())
        self._total = len(stages)
        self._carry = None  # the previously-opened stage dict (mutations visible)
        self.current_key = None
        self.position = 0
        self.verbose = verbose

    def __len__(self):
        return self._total

    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            raise StopIteration
        key, stage = self._pending.pop(0)
        if self._carry is not None:
            # Fold every not-overridden key of the previous stage (as mutated by
            # the runner since it opened) into this one.
            for k, v in self._carry.items():
                stage.setdefault(k, v)
        self._carry = stage
        self.current_key = key
        self.position += 1
        if self.verbose:
            print(f"stage sweep: opening '{key}' [{self.position}/{self._total}]")
        return stage


def _chain_previous_transform_checkpoint(stage):
    """Promote the previous stage's best save into this stage's transform
    checkpoint. When no ``save_path`` was handed forward (e.g. ``stage_override``
    starts the sweep at a non-first stage), leave the key alone so a
    config-provided ``transform_model_checkpoint_path`` survives — but warn,
    because in a full sweep a missing save_path means checkpoint chaining was
    silently dropped (e.g. save_every=None in the previous stage)."""
    save_path = stage.get('save_path')
    if save_path is not None:
        stage['transform_model_checkpoint_path'] = save_path
    else:
        import warnings
        warnings.warn(
            "opt_view stage opened without a handed-forward save_path: previous "
            "views' learned orientations are NOT chained in (the previous stage "
            "saved no checkpoint — check save_every). Falling back to "
            f"transform_model_checkpoint_path="
            f"{stage.get('transform_model_checkpoint_path')!r}.",
            stacklevel=2)


def merge_stage_config(config, stage):
    """Overlay an opened stage onto the base config (reference run_dl.py:668-678:
    stage keys override config keys for the stage's run). Only keys the config
    already knows are merged, plus the runner-facing stage handles."""
    stage_config = config.copy()
    stage_config.update(
        {k: stage[k] for k in set(stage) & set(stage_config)} |
        {k: stage[k] for k in ('n_active_views', 'transform_model_checkpoint_path',
                               'save_path') if k in stage})
    return stage_config


def get_std_stages(config):
    """Standard sweep: opt_view{0..V-1} then 'ref' (reference stages.py:58-89)."""
    n_views = len(config['base_views'])
    epochs = int(config['epochs'])

    std_stages = {}
    for view_idx in range(n_views):
        std_stages[f'opt_view{view_idx}'] = Stage(
            on_open=_chain_previous_transform_checkpoint if view_idx else None,
            view_optimization_mode='opt-current-fix-previous',
            epochs=epochs,
            use_affine_theta=True,
            do_output=True,
            n_active_views=view_idx + 1,
        )

    # 'ref' has no on_open hook: it inherits the transform checkpoint key as-is
    # (reference stages.py:76-82). With use_affine_theta=False the ATM weights
    # are loaded but NOT evaluated — thetas are identity (train.py), so the ref
    # stage measures the *clinically initialized* view planes. This matches the
    # reference: its ref stage computes init affines with theta ~= identity
    # (learnable_transform.py:148-170,262-268); it is the baseline the opt_view
    # stages are compared against, not a stage that replays learned views.
    std_stages['ref'] = Stage(
        do_output=True,
        view_optimization_mode='opt-none',
        epochs=epochs,
        use_affine_theta=False,
        n_active_views=n_views,
    )

    override = config.get('stage_override')
    if override is not None:
        std_stages = {k: v for k, v in std_stages.items() if k == override}
    return StageSweep(std_stages, verbose=True)
