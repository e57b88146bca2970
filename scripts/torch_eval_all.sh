#!/usr/bin/env bash
# Evaluate every trained run directory with the standard DeepMimic reward
# through the PyTorch port, on the card; prints one JSON line per skill:
#   scripts/torch_eval_all.sh ckpts_torch/*
set -uo pipefail
for d in "$@"; do
  [ -d "$d" ] || continue
  echo -n "$(basename "$d"): "
  python -m pbrl_tpu_torch.cli eval --checkpoint-dir "$d" 2>/dev/null | tail -1
done
