#!/usr/bin/env bash
# Train imitation policies for every bundled DeepMimic clip on the card
# with the PyTorch port: the recipes of scripts/train_all_clips.sh, flag
# for flag, through `python -m pbrl_tpu_torch.cli`. Ballistic and
# floor-contact clips get the configuration their converted poses require
# (README, EnvConfig's docstrings); the ballistic clips also use pose
# termination (relaxed after a cycle), the takeoff-state curriculum and
# the reference-relative root-offset observation, and backflip the aerial
# reward window and link-state observations.
set -euo pipefail

STEPS="${STEPS:-500000000}"
ENVS="${ENVS:-2048}"
OUT="${OUT:-ckpts_torch}"

run() { echo ">>> $*"; python -m pbrl_tpu_torch.cli "$@"; }

# upright gait, within joint limits: plain absolute-target training
run train --clip walk --num-envs "$ENVS" --total-steps "$STEPS" \
    --checkpoint-dir "$OUT/walk" --quiet

# ballistic, within joint limits: + termination shaping + curriculum
run train --clip jump --num-envs "$ENVS" --total-steps "$STEPS" \
    --pose-termination 1.57 \
    --env-set pose_termination_after_cycle=2.4 \
    --env-set rsi_noise_qpos=0.02 --env-set rsi_noise_qvel=0.2 \
    --env-set curriculum_reset_prob=0.15 \
    --env-set curriculum_phase_window=0.6,0.95 \
    --env-set include_ref_root_offset=true \
    --checkpoint-dir "$OUT/jump" --quiet

# poses exceed the model's hinge ranges: residual prior, no limits
for clip in kick punch; do
  run train --clip "$clip" --num-envs "$ENVS" --total-steps "$STEPS" \
      --action-mode residual --no-joint-limits \
      --checkpoint-dir "$OUT/$clip" --quiet
done

# backflip: the full recipe (docs/BACKFLIP_EXPERIMENTS.md)
run train --clip backflip --num-envs "$ENVS" --total-steps 1000000000 \
    --action-mode residual --no-joint-limits --pose-termination 1.57 \
    --env-set aerial_window=0.27,0.5 \
    --env-set pose_termination_after_cycle=2.4 \
    --env-set curriculum_reset_prob=0.15 \
    --env-set curriculum_phase_window=0.5,0.95 \
    --env-set include_ref_root_offset=true \
    --env-set include_link_obs=true \
    --checkpoint-dir "$OUT/backflip" --quiet

# floor-contact clips: ground touches are part of the motion
for clip in getup_facedown getup_faceup; do
  run train --clip "$clip" --num-envs "$ENVS" --total-steps "$STEPS" \
      --action-mode residual --no-joint-limits --no-early-termination \
      --checkpoint-dir "$OUT/$clip" --quiet
done
