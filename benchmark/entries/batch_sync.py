# -*- coding: utf-8 -*-
"""One request is one batch: ``ffsubsync_tpu_torch.batch.sync_batch`` of
one job per film of the pool (the library form of ``ffs-torch-batch``),
with its default flags and the traffic's keyword arguments."""
import os


def request(ctx, k):
    """Sync batch ``k``; returns its jobs, each with the files it read and
    wrote and the answer it reported."""
    from ffsubsync_tpu_torch.batch import sync_batch

    media = ctx.media
    n = len(media.wavs)
    jobs = []
    for e in range(n):
        j = (k * n + e) % len(media.srt_paths)
        jobs.append((media.wavs[j % n], media.srt_paths[j],
                     os.path.join(ctx.outdir, "out%d_%d.srt" % (k, e))))
    results = sync_batch(jobs, **ctx.traffic.get("kwargs", {}))
    return [{"wav": wav, "srt": srt, "out": out,
             "ok": r["error"] is None and bool(r["sync_was_successful"]),
             "ratio": r["framerate_scale_factor"], "offset_s": r["offset_seconds"]}
            for (wav, srt, out), r in zip(jobs, results)]
