#!/usr/bin/env bash
# Demo driver of the port (the shape of the reference's predict.sh): query
# images are NVS renders from the gaussian-splatting TEST split; references are
# REAL captures from the TRAIN split. Runs the port's predict CLI on one CUDA
# card; add trainer.accelerator=cpu to run the plain versions on the CPU.
# Run from the repository root: bash crossscore_tpu_torch/predict.sh

ckpt_path=ckpt/CrossScore-v1.0.0.ckpt
data_dir=datadir/processed_training_ready/gaussian/map-free-reloc/res_540

for scene_name in s00076 s00231; do

  query_dir=$data_dir/$scene_name/test/ours_15000/renders
  reference_dir=$data_dir/$scene_name/train/ours_15000/gt

  python -m crossscore_tpu_torch.tasks.predict \
    trainer.ckpt_path_to_load=$ckpt_path \
    data.dataset.query_dir=$query_dir \
    data.dataset.reference_dir=$reference_dir \
    alias=$scene_name
done
