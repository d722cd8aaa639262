# -*- coding: utf-8 -*-
"""Version info.

The reference derives its version from git tags via versioneer
(ffsubsync/_version.py, ~520 lines) and checks GitHub for newer releases
(ffsubsync/version.py:43-57). Here the same outcomes come from a small
resolution chain: a build-time-generated ``_version.py`` (written by
setup.py), a live ``git describe`` for working checkouts, installed package
metadata, and finally a static fallback.
"""
import logging
import os
import re
import subprocess
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

# static fallback when no richer source is available (e.g. a bare source
# tarball with no git metadata and no installed dist-info)
_FALLBACK_VERSION = "0.2.0"

# this project's own release feed; the reference points at its repo's
# (smacke/ffsubsync) — pointing a 0.x fork at the reference's tags would
# make every run report a phantom update
RELEASE_API_URL = (
    "https://api.github.com/repos/ffsubsync-tpu/ffsubsync-tpu/releases/latest"
)

_DESCRIBE_RE = re.compile(
    r"^v?(?P<tag>[0-9][^-]*(?:-[^-]+)*?)-(?P<distance>\d+)-g(?P<sha>[0-9a-f]+)"
    r"(?P<dirty>-dirty)?$"
)


def _version_from_git() -> Optional[str]:
    """PEP 440-ish version from ``git describe`` for working checkouts:
    ``0.2.0`` at a tag, ``0.2.0.post3+g1a2b3c4`` three commits past it,
    ``0.2.0.dev0+g1a2b3c4`` with no tags at all.

    Guarded against FOREIGN repositories: an installed copy sitting inside
    some unrelated git work tree (site-packages under a user's project)
    must not pick up that repo's tags, so git is consulted only when this
    very file is tracked by the repo that contains it (versioneer's
    equivalent safety check)."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        tracked = subprocess.run(
            ["git", "ls-files", "--error-unmatch", "version.py"],
            cwd=here,
            capture_output=True,
            text=True,
            timeout=5,
        )
        if tracked.returncode != 0:
            return None
        out = subprocess.run(
            ["git", "describe", "--tags", "--long", "--dirty", "--always"],
            cwd=here,
            capture_output=True,
            text=True,
            timeout=5,
        )
    except Exception:
        return None
    if out.returncode != 0:
        return None
    described = out.stdout.strip()
    match = _DESCRIBE_RE.match(described)
    if match is None:
        # no tags yet: describe printed a bare commit hash
        dirty = described.endswith("-dirty")
        sha = described.replace("-dirty", "")
        if re.fullmatch(r"[0-9a-f]{7,40}", sha):
            version = "%s.dev0+g%s" % (_FALLBACK_VERSION, sha[:9])
            return version + ".dirty" if dirty else version
        return None
    version = match.group("tag")
    if match.group("distance") != "0":
        version += ".post%s+g%s" % (match.group("distance"), match.group("sha"))
    if match.group("dirty"):
        version += ".dirty" if "+" in version else "+dirty"
    return version


def _detect_version() -> str:
    # 1. live git checkout — takes precedence over a lingering generated
    # _version.py so a rebuild after new commits/tags never re-pins the
    # stale version the previous build wrote (release artifacts carry no
    # git metadata, so they fall through to the pin)
    from_git = _version_from_git()
    if from_git is not None:
        return from_git
    # 2. build-time pin written by setup.py (release artifacts)
    try:
        from ffsubsync_tpu_torch._version import version  # type: ignore

        return version
    except ImportError:
        pass
    # 3. installed package metadata
    try:
        from importlib.metadata import version as dist_version

        return dist_version("ffsubsync-tpu")
    except Exception:
        pass
    return _FALLBACK_VERSION


__version__ = _detect_version()


def get_version() -> str:
    return __version__


def make_version_tuple(vstr: Optional[str] = None) -> Tuple[int, ...]:
    if vstr is None:
        vstr = __version__
    if vstr[0] == "v":
        vstr = vstr[1:]
    components = []
    for component in vstr.split("+")[0].split("."):
        try:
            components.append(int(component))
        except ValueError:
            break
    return tuple(components)


def update_available() -> bool:
    """Check this project's releases for something newer; False on any
    failure (offline, no releases, unparseable tag)."""
    try:
        import json
        import urllib.request

        resp = urllib.request.urlopen(RELEASE_API_URL, timeout=1)
        latest_vstr = json.loads(resp.read().decode("utf-8"))["tag_name"]
    except Exception:
        return False
    try:
        return make_version_tuple(__version__) < make_version_tuple(latest_vstr)
    except Exception:
        return False
