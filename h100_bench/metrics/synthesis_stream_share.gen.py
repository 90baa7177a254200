"""synthesis_stream_share.gen: the share of the sres windows that
`sample_video_segments` enqueued on its synthesis stream, over all the
windows it enqueued in this process (the program's counters
`generator_sres.stream_segments` and `segments`), in percent. Nothing where
the program has no such counters or enqueued no window."""


def read(ctx):
    from long_video_gan_tpu_torch.models import generator_sres

    segments = getattr(generator_sres, "segments", 0)
    stream_segments = getattr(generator_sres, "stream_segments", None)
    if stream_segments is None or not segments:
        return None
    return 100.0 * stream_segments / segments
