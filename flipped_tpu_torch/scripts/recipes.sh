#!/usr/bin/env bash
# Benchmark training recipes of the port: the reference's README commands
# (reference: README.md:62-96) on flipped_tpu_torch.cli.train, one card.
# The reference splits each recipe's global batch across 4-8 GPUs with
# torchrun; here --batch_size is the global batch per optimizer microstep
# (reference batch_size x #GPUs), on one card, or split over the dp ranks
# of a torchrun launch (--dp N).
#   bash flipped_tpu_torch/scripts/recipes.sh nextqa
set -e
DATASET=${1:-nextqa}
LLAMA=${LLAMA_PATH:-./pretrained/llama/}

case "$DATASET" in
nextqa)  # README.md:62-64
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 128 --batch_size 32 --accum_iter 2 --epochs 5 --warmup_epochs 2 \
    --blr 9e-2 --weight_decay 0.14 --bias 3.5 --tau 100 --max_feats 10 \
    --dataset nextqa --vaq --qav --output_dir ./output_dir/nextqa ;;
star)  # README.md:70-72
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 128 --batch_size 32 --accum_iter 1 --epochs 5 --warmup_epochs 2 \
    --blr 9e-2 --weight_decay 0.16 --bias 3 --tau 100 --max_feats 10 \
    --dataset star --vaq --qav --output_dir ./output_dir/star ;;
dramaqa)  # README.md:78-80
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 384 --batch_size 8 --accum_iter 8 --epochs 5 --warmup_epochs 2 \
    --blr 9e-2 --weight_decay 0.10 --bias 3 --tau 100 --max_feats 10 \
    --dataset dramaqa --vaq --qav --output_dir ./output_dir/dramaqa ;;
vlep)  # README.md:86-88
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 256 --batch_size 16 --accum_iter 8 --epochs 5 --warmup_epochs 2 \
    --blr 6e-2 --weight_decay 0.20 --bias 3 --tau 100 --max_feats 10 \
    --dataset vlep --sub --qav --output_dir ./output_dir/vlep ;;
tvqa)  # README.md:94-96
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 650 --batch_size 8 --accum_iter 4 --epochs 5 --warmup_epochs 2 \
    --blr 7e-2 --weight_decay 0.02 --bias 3 --tau 100 --max_feats 10 \
    --dataset tvqa --sub --vaq --qav --output_dir ./output_dir/tvqa ;;
musicavqa)
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 128 --batch_size 32 --accum_iter 1 --epochs 5 --warmup_epochs 2 \
    --blr 9e-2 --weight_decay 0.14 --bias 3 --tau 100 --max_feats 10 \
    --dataset musicavqa --is_generation_task --output_dir ./output_dir/musicavqa ;;
valor32k)
  python -m flipped_tpu_torch.cli.train --model llama7B --llama_model_path "$LLAMA" \
    --max_seq_len 128 --batch_size 32 --accum_iter 1 --epochs 5 --warmup_epochs 2 \
    --blr 9e-2 --weight_decay 0.14 --bias 3 --tau 100 --max_feats 10 \
    --dataset valor32k --output_dir ./output_dir/valor32k ;;
*) echo "unknown dataset: $DATASET"; exit 1 ;;
esac
