# -*- coding: utf-8 -*-
"""ffmpeg / ffprobe integration utilities.

ffmpeg stays an *external decode tool* invoked as a binary (never linked),
exactly as in the reference — decode is I/O, not accelerator compute. This
module handles binary resolution (--ffmpeg-path > bundled-resources env var >
PATH; parity: ffsubsync/ffmpeg_utils.py:69-87), PyInstaller/Windows-safe
subprocess arguments (:24-66), and a minimal ffprobe JSON wrapper replacing
the reference's ``ffmpeg-python`` dependency's ``probe`` call.
"""
import json
import logging
import os
import platform
import subprocess
from typing import Any, Dict, List, Optional

from ffsubsync_tpu_torch.constants import SUBSYNC_RESOURCES_ENV_MAGIC
from ffsubsync_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


def subprocess_args(include_stdout: bool = True) -> Dict[str, Any]:
    """Popen kwargs that behave under PyInstaller ``--noconsole`` on Windows."""
    if hasattr(subprocess, "STARTUPINFO"):  # Windows only
        si = subprocess.STARTUPINFO()  # type: ignore[attr-defined]
        si.dwFlags |= subprocess.STARTF_USESHOWWINDOW  # type: ignore[attr-defined]
        env = os.environ
    else:
        si = None
        env = None
    ret: Dict[str, Any] = {"stdout": subprocess.PIPE} if include_stdout else {}
    ret.update(
        {
            "stdin": subprocess.PIPE,
            "stderr": subprocess.PIPE,
            "startupinfo": si,
            "env": env,
        }
    )
    return ret


def ffmpeg_bin_path(
    bin_name: str, gui_mode: bool = False, ffmpeg_resources_path: Optional[str] = None
) -> str:
    """Resolve the ffmpeg/ffprobe binary path.

    Precedence: explicit ``--ffmpeg-path`` > bundled resources dir (env magic)
    > bare name (system PATH).
    """
    if platform.system() == "Windows":
        bin_name = "{}.exe".format(bin_name)
    if ffmpeg_resources_path is not None:
        if not os.path.isdir(ffmpeg_resources_path):
            if bin_name.lower().startswith("ffmpeg"):
                return ffmpeg_resources_path
            ffmpeg_resources_path = os.path.dirname(ffmpeg_resources_path)
        return os.path.join(ffmpeg_resources_path, bin_name)
    try:
        resource_path = os.environ[SUBSYNC_RESOURCES_ENV_MAGIC]
        if len(resource_path) > 0:
            return os.path.join(resource_path, "ffmpeg-bin", bin_name)
    except KeyError:
        if gui_mode:
            logger.info(
                "Couldn't find resource path; falling back to searching system path"
            )
    return bin_name


def ffprobe_json(
    fname: str,
    gui_mode: bool = False,
    ffmpeg_resources_path: Optional[str] = None,
    extra_args: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Run ffprobe and return its JSON output (streams + format by default).

    Replaces ``ffmpeg.probe`` from the reference's ffmpeg-python dependency.
    Raises on a non-zero exit or unparseable output.
    """
    args = [
        ffmpeg_bin_path("ffprobe", gui_mode, ffmpeg_resources_path),
        "-v",
        "error",
        "-print_format",
        "json",
        "-show_format",
        "-show_streams",
    ]
    if extra_args:
        args.extend(extra_args)
    args.append(fname)
    with tracing.span("spawn"):
        process = subprocess.Popen(args, **subprocess_args(include_stdout=True))
    out, err = process.communicate()
    if process.returncode != 0:
        raise RuntimeError(
            "ffprobe failed (%d): %s"
            % (process.returncode, (err or b"").decode("utf-8", "replace")[:500])
        )
    return json.loads(out.decode("utf-8", "replace"))


def probe_duration(
    fname: str, gui_mode: bool = False, ffmpeg_resources_path: Optional[str] = None
) -> float:
    """Container duration in seconds (raises if unavailable)."""
    probe = ffprobe_json(fname, gui_mode, ffmpeg_resources_path)
    return float(probe["format"]["duration"])
