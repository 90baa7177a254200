"""long_video_gan_tpu_torch.parallel: several processes over torch.distributed."""
