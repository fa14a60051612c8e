#!/bin/sh
# The port on one card: the smoke, then the card tests, each log written
# whole under LOGDIR (default: logs) and its end printed.  Run from the
# repository root:
#   sh scripts/torch_card_checks.sh [LOGDIR]
out=${1:-logs}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 chip_smoke.py > "$out/smoke.txt" 2>&1; rc=$?
echo "smoke rc=$rc"; tail -c 6000 "$out/smoke.txt"
python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py -x -p no:cacheprovider > "$out/cuda_tests.txt" 2>&1; echo "cuda tests rc=$?"; tail -n 15 "$out/cuda_tests.txt"
