"""long_video_gan_tpu_torch.data"""
