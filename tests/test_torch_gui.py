# -*- coding: utf-8 -*-
"""The port's Gooey front end (``ffsubsync_tpu_torch/gui.py``, a copy of
the JAX package's with the package name substituted) against the
reference's: it imports without Gooey, asks for it when a parser is built,
gives the same arguments, and fills the CLI's defaults the same way.
Gooey is not installed; a stub stands in for it."""
import argparse
import sys
import types

import pytest

from ffsubsync_tpu import gui as jgui
from ffsubsync_tpu_torch import gui as tgui

PACKAGES = {"port": tgui, "reference": jgui}


class _StubParser(argparse.ArgumentParser):
    """An ``argparse`` parser that takes Gooey's ``widget=`` and drops it."""

    def add_argument_group(self, *args, **kwargs):
        group = super().add_argument_group(*args, **kwargs)
        add = group.add_argument

        def add_argument(*a, widget=None, **kw):
            return add(*a, **kw)

        group.add_argument = add_argument
        return group


def _arguments(parser):
    return [(a.option_strings, a.dest, a.default, a.help, a.choices, a.nargs, a.type)
            for a in parser._actions]


def _fake_gooey(decorations):
    def gooey(**settings):
        def decorate(build):
            decorations.append(settings)
            return build
        return decorate

    return types.SimpleNamespace(Gooey=gooey, GooeyParser=_StubParser)


def test_gui_imports_and_asks_for_gooey(monkeypatch):
    monkeypatch.setitem(sys.modules, "gooey", None)  # an import of it raises
    with pytest.raises(ImportError, match="pip install gooey"):
        tgui.make_parser()


def test_populated_parser_equals_reference():
    ours = tgui._populate_parser(_StubParser())
    theirs = jgui._populate_parser(_StubParser())
    assert _arguments(ours) == _arguments(theirs)
    assert [g.title for g in ours._action_groups] == [g.title for g in theirs._action_groups]
    args = ours.parse_args(["ref.mkv", "in.srt", "--vad", "fused"])
    assert (args.reference, args.srtin, args.vad) == ("ref.mkv", "in.srt", "fused")


def test_make_parser_with_gooey_equals_reference(monkeypatch):
    """With a stand-in Gooey: the same decoration (the package's own image
    directory apart) and the same parser."""
    built = {}
    for name, gui in PACKAGES.items():
        decorations = []
        monkeypatch.setitem(sys.modules, "gooey", _fake_gooey(decorations))
        monkeypatch.setattr(gui, "update_available", lambda: False)
        parser = gui.make_parser()
        built[name] = (decorations, _arguments(parser), parser.description)
    (ours, our_args, our_text), (theirs, their_args, their_text) = built["port"], built["reference"]
    assert [d.pop("image_dir") for d in ours] == [":ffsubsync_tpu_torch"]
    assert [d.pop("image_dir") for d in theirs] == [":ffsubsync_tpu"]
    assert ours == theirs and our_args == their_args and our_text == their_text


@pytest.mark.parametrize("argv", [["ref.mkv", "in.srt"],
                                  ["ref.srt", "in.ass", "-o", "out.ass", "--vad", "webrtc",
                                   "--max-offset-seconds", "30", "--merge"]],
                         ids=["defaults", "flags"])
def test_main_fills_the_cli_defaults_as_the_reference(monkeypatch, argv):
    """``main`` with its parser's arguments, the rest filled from the CLI
    parser's defaults, run with ``gui_mode``: the namespace handed to
    ``sync.run`` equals the reference's, and ``main`` returns its
    ``retval``."""
    import ffsubsync_tpu.sync
    import ffsubsync_tpu_torch.sync

    seen = {}
    for name, gui, sync in (("port", tgui, ffsubsync_tpu_torch.sync),
                            ("reference", jgui, ffsubsync_tpu.sync)):
        monkeypatch.setattr(gui, "make_parser", lambda gui=gui: gui._populate_parser(_StubParser()))
        monkeypatch.setattr(sync, "run", lambda args, name=name: seen.update({name: vars(args)})
                            or {"retval": 3})
        monkeypatch.setattr(sys, "argv", ["ffs-gui"] + argv)
        assert gui.main() == 3
    ours, theirs = seen["port"], seen["reference"]
    assert ours == theirs
    assert ours["gui_mode"] is True and ours["srtin"] == [argv[1]]
    cli_defaults = vars(ffsubsync_tpu_torch.sync.make_parser().parse_args([argv[0]]))
    assert set(cli_defaults) <= set(ours)
    assert ours["srtout"] == (argv[argv.index("-o") + 1] if "-o" in argv else None)
