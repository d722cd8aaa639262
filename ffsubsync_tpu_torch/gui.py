# -*- coding: utf-8 -*-
"""Gooey GUI frontend (parity: reference ffsubsync_gui.py:56-121).

Wraps the shared argument surface in Gooey widgets and runs the sync with
``gui_mode=True`` (which switches progress to stdout percent prints that
Gooey's ``progress_regex`` consumes). Gooey is an optional dependency: the
module imports cleanly without it, and :func:`make_parser` / :func:`main`
raise a clear error when it is actually needed.
"""
import logging
import sys

from ffsubsync_tpu_torch.constants import (
    DEFAULT_MAX_OFFSET_SECONDS,
    DEFAULT_VAD,
    DESCRIPTION,
    PROJECT_NAME,
)
from ffsubsync_tpu_torch.version import get_version, update_available

logger = logging.getLogger(__name__)

_GOOEY_SETTINGS = dict(
    program_name=PROJECT_NAME,
    image_dir=":ffsubsync_tpu_torch",
    tabbed_groups=True,
    progress_regex=r"(\d+)%",
    hide_progress_msg=True,
)


def _import_gooey():
    try:
        from gooey import Gooey, GooeyParser
    except ImportError as e:
        raise ImportError(
            "the GUI requires the optional 'gooey' dependency: "
            "pip install gooey"
        ) from e
    return Gooey, GooeyParser


def _about_menu():
    return [
        {
            "name": "File",
            "items": [
                {
                    "type": "AboutDialog",
                    "menuTitle": "About",
                    "name": PROJECT_NAME,
                    "description": DESCRIPTION,
                    "version": get_version(),
                }
            ],
        }
    ]


def _populate_parser(parser):
    """Add the GUI argument surface to a (Gooey)Parser."""
    main_group = parser.add_argument_group("Basic")
    main_group.add_argument(
        "reference",
        help="Reference video or subtitles to synchronize to.",
        widget="FileChooser",
    )
    main_group.add_argument(
        "srtin", help="Input subtitles to synchronize.", widget="FileChooser"
    )
    main_group.add_argument(
        "-o",
        "--srtout",
        help="Output subtitles file (default: <input>.synced.srt).",
        widget="FileSaver",
    )
    advanced_group = parser.add_argument_group("Advanced")
    advanced_group.add_argument(
        "--merge-with-reference",
        "--merge",
        action="store_true",
        help="Merge reference subtitles with synced output subtitles.",
    )
    advanced_group.add_argument(
        "--make-test-case",
        "--create-test-case",
        action="store_true",
        help="Create a test archive to attach to bug reports.",
    )
    advanced_group.add_argument(
        "--reference-stream",
        "--refstream",
        "--reference-track",
        "--reftrack",
        default=None,
        help="Which stream/track in the video file to use as reference "
        "(ffmpeg conventions, e.g. s:0 or a:3).",
    )
    advanced_group.add_argument(
        "--vad",
        choices=[
            "subs_then_webrtc",
            "webrtc",
            "subs_then_auditok",
            "auditok",
            "subs_then_silero",
            "silero",
            "fused",
        ],
        default=None,
        help="Voice activity detector to use (default={}).".format(DEFAULT_VAD),
    )
    advanced_group.add_argument(
        "--max-offset-seconds",
        type=float,
        default=DEFAULT_MAX_OFFSET_SECONDS,
        help="Maximum allowed offset seconds for any subtitle segment.",
    )
    return parser


def make_parser():
    """Build the Gooey-decorated parser (imports gooey on first use)."""
    Gooey, GooeyParser = _import_gooey()

    @Gooey(menu=_about_menu(), **_GOOEY_SETTINGS)
    def _build():
        description = DESCRIPTION
        if update_available():
            description += (
                "\nUpdate available! Please go to the website to update."
            )
        return _populate_parser(GooeyParser(description=description))

    return _build()


def main() -> int:
    from ffsubsync_tpu_torch.sync import run

    parser = make_parser()
    args = parser.parse_args()
    args.srtin = [args.srtin]
    args.gui_mode = True
    args.srtout = args.srtout or None
    # fill CLI-only defaults the GUI parser does not expose
    from ffsubsync_tpu_torch.cli import make_parser as make_cli_parser

    defaults = vars(make_cli_parser().parse_args([args.reference]))
    for key, value in defaults.items():
        if not hasattr(args, key):
            setattr(args, key, value)
    return run(args)["retval"]


if __name__ == "__main__":
    sys.exit(main())
