"""Training entry point (reference: src/main.py; JAX:
centertrack_tpu/cli/main.py).

Usage (MOT17's recipe, experiments/mot17_half.sh:4-8):
  python -m centertrack_tpu_torch.cli.main tracking --exp_id mot17_half \
      --dataset mot --dataset_version 17halftrain --pre_hm --ltrb_amodal \
      --same_aug_pre --hm_disturb 0.05 --lost_disturb 0.4 --fp_disturb 0.1

Writes exp/<task>/<exp_id>/: opt.txt and logs_<time>/log.txt (the
Logger), model_last.ckpt after every epoch (with the optimizer state) and
model_<epoch>.ckpt at every val_intervals-th epoch and at save_point, in
the JAX package's checkpoint format. ``--load_model`` starts from a
checkpoint; ``--resume`` continues from the run's model_last.ckpt at the
epoch after the one it saved. ``--device cpu`` trains on the CPU (each
kernel's plain version); the default is the card.
"""

from __future__ import annotations

import os

import numpy as np

from centertrack_tpu_torch.cli.opts import (args_to_config, build_parser,
                                            exp_dir)
from centertrack_tpu_torch.config import finalize
from centertrack_tpu_torch.data.datasets import get_dataset
from centertrack_tpu_torch.data.loader import DataLoader
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.model import create_model
from centertrack_tpu_torch.utils.logger import Logger


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    dataset_cls = get_dataset(cfg.dataset)
    cfg = finalize(cfg, dataset_cls)
    np.random.seed(cfg.seed)

    save_dir = exp_dir(cfg)
    os.makedirs(save_dir, exist_ok=True)
    logger = Logger(cfg, save_dir)

    print("Creating model...")
    trainer = Trainer(cfg, create_model(cfg, args.device), args.device)
    # load_backbone, load_model, or --resume's model_last.ckpt (opts)
    start_epoch = trainer.start(save_dir)

    print("Setting up data...")
    train_loader = DataLoader(dataset_cls(cfg, "train"), cfg.batch_size,
                              shuffle=True, num_workers=cfg.num_workers,
                              seed=cfg.seed,
                              use_processes=cfg.process_workers)
    val_loader = None
    if cfg.val_intervals < cfg.num_epochs or args.eval_val:
        val_loader = DataLoader(dataset_cls(cfg, "val"), cfg.batch_size,
                                shuffle=False, num_workers=cfg.num_workers,
                                use_processes=cfg.process_workers)

    print("Starting training...")
    for epoch in range(start_epoch + 1, cfg.num_epochs + 1):
        stats = trainer.train(epoch, train_loader, cfg.num_iters)
        logger.write(f"epoch: {epoch} |" + "".join(
            f" {k} {v:8f} |" for k, v in stats.items()))
        for k, v in stats.items():
            logger.scalar_summary(f"train_{k}", v, epoch)
        trainer.save(os.path.join(save_dir, "model_last.ckpt"), epoch)
        if cfg.val_intervals > 0 and epoch % cfg.val_intervals == 0 \
                and val_loader is not None:
            vstats = trainer.val(epoch, val_loader, cfg.num_iters)
            for k, v in vstats.items():
                logger.scalar_summary(f"val_{k}", v, epoch)
            trainer.save(os.path.join(save_dir, f"model_{epoch}.ckpt"),
                         epoch, optimizer=False)
        if epoch in cfg.save_point:
            trainer.save(os.path.join(save_dir, f"model_{epoch}.ckpt"),
                         epoch, optimizer=False)
        # the learning rate drops by make_lr_schedule(epoch)
    logger.close()


if __name__ == "__main__":
    main()
