#!/usr/bin/env bash
# Render one policy rollout per shipped skill through the PyTorch port: each
# clip's bundled policy, 240 policy steps of one env on the card (one kernel
# launch per step), the trajectory as .npz and a video from the back camera
# (a GIF when there is no ffmpeg). The rollout needs CUDA and the video needs
# MuJoCo, so run it on a host that has both. Outputs go to $OUT, by default a
# directory under $TMPDIR, outside the checkout. It exits 1, naming the
# skills, if any skill's rollout or video failed:
#   OUT=renders scripts/torch_render_all_skills.sh
set -uo pipefail
OUT="${OUT:-${TMPDIR:-/tmp}/pbrl_torch_renders}"
mkdir -p "$OUT"
failed=()
for skill in walk jump backflip kick punch getup_facedown getup_faceup; do
  echo ">>> $skill"
  python -m pbrl_tpu_torch.cli rollout --clip "$skill" --steps 240 \
    --out "$OUT/$skill.npz" --video "$OUT/$skill.mp4" --camera back \
    || failed+=("$skill")
done
ls -la "$OUT"
if ((${#failed[@]})); then
  echo "RENDER FAILED: ${failed[*]}" >&2
  exit 1
fi
