"""CLI entry points of the port:

  python -m gm3d_tpu_torch.cli.export_model   (config [+ checkpoint or .pth] -> .gm3dx artifact)
  python -m gm3d_tpu_torch.cli.serve          (artifact -> HTTP server)
  python -m gm3d_tpu_torch.cli.pretrain       (GM3D / Point-MAE pretraining, epochs of the step)
  python -m gm3d_tpu_torch.cli.finetune       (pretrain checkpoint -> classifier)

Each runs on the GPU unless ``--device cpu`` is given.
"""
