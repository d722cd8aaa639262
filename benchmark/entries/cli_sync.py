# -*- coding: utf-8 -*-
"""One request is one CLI sync: ``ffsubsync_tpu_torch.sync.run`` of the
parsed arguments ``<film>.wav -i <request>.srt -o <out>.srt`` plus the
traffic's flags, as a user or a script syncing file after file."""
import os


def request(ctx, k):
    """Sync request ``k``; returns its one job: the files it read and wrote
    and the answer it reported."""
    from ffsubsync_tpu_torch import sync
    from ffsubsync_tpu_torch.cli import make_parser

    media = ctx.media
    j = k % len(media.srt_paths)
    wav = media.wavs[j % len(media.wavs)]
    out = os.path.join(ctx.outdir, "out%d.srt" % k)
    argv = [wav, "-i", media.srt_paths[j], "-o", out] + list(ctx.traffic["flags"])
    result = sync.run(make_parser().parse_args(argv))
    ok = result.get("retval") == 0 and bool(result.get("sync_was_successful"))
    return [{"wav": wav, "srt": media.srt_paths[j], "out": out, "ok": ok,
             "ratio": result.get("framerate_scale_factor"),
             "offset_s": result.get("offset_seconds")}]
