"""The per-fold stage sweep (torch port of ``stage_sweep_run`` in the JAX package's
``main.py``), over the port's own copy of the stage machinery
(``engine/stages.py``: ``get_std_stages``, ``merge_stage_config``).

The CLI (``main()``, ``build_fold_iter``) needs the dataset build, which is not
ported yet.
"""

import json
from pathlib import Path

from acquisition_focus_tpu_torch.engine.checkpoint import checkpoint_exists
from acquisition_focus_tpu_torch.engine.config import DotDict
from acquisition_focus_tpu_torch.engine.runner import run_dl
from acquisition_focus_tpu_torch.engine.stages import get_std_stages, merge_stage_config

__all__ = ['get_std_stages', 'stage_sweep_run']


def _load_sweep_state(path):
    p = Path(path)
    if p.exists():
        return json.loads(p.read_text())
    return {'completed': {}, 'in_progress': None}


def _save_sweep_state(path, state):
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
    unless the caller asks for ``'cpu'``."""
    state_path = config.get('sweep_state_path')
    fold_key = f"fold-{fold_properties[0]}"
    state = _load_sweep_state(state_path) if state_path else None

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
