"""The env registry, the port's copy of the JAX package's ``envfile.py``:
the reference's ``/mnt/shared/setenv``, a file every installer appends
``export`` lines to and every launch script sources.

Components register their exports into one file (``~/.tpu_hc_bench/
setenv``, or ``$TPU_HC_BENCH_SETENV``); scripts ``source`` it.  Each
block is keyed by a tag, so registering a tag again replaces its block
instead of appending a duplicate.  The file is JAX's byte for byte.
The default path is read when a call is made, not at import, so a
process that points ``HOME`` or ``$TPU_HC_BENCH_SETENV`` elsewhere
writes there.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

SETENV_ENV = "TPU_HC_BENCH_SETENV"

_BEGIN = "# >>> tpu_hc_bench:{tag} >>>"
_END = "# <<< tpu_hc_bench:{tag} <<<"


def default_path() -> Path:
    return Path(os.environ.get(
        SETENV_ENV, str(Path.home() / ".tpu_hc_bench" / "setenv")))


def register(tag: str, exports: dict[str, str],
             path: Path | None = None) -> Path:
    """Write or replace the tagged export block in the registry file."""
    path = Path(path or default_path())
    path.parent.mkdir(parents=True, exist_ok=True)
    begin, end = _BEGIN.format(tag=tag), _END.format(tag=tag)
    block = "\n".join(
        [begin] + [f"export {k}={_quote(v)}" for k, v in exports.items()]
        + [end])
    text = path.read_text() if path.exists() else ""
    pattern = re.compile(re.escape(begin) + r".*?" + re.escape(end),
                         flags=re.DOTALL)
    if pattern.search(text):
        # a function replacement: the block's text is never read as a
        # template (a backslash in a value stays a backslash)
        text = pattern.sub(lambda _m: block, text)
    else:
        if text and not text.endswith("\n"):
            text += "\n"
        text += block + "\n"
    path.write_text(text)
    return path


def read(path: Path | None = None) -> dict[str, str]:
    """Every export in the registry file, parsed back."""
    path = Path(path or default_path())
    out: dict[str, str] = {}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        m = re.match(r"export\s+([A-Za-z_][A-Za-z0-9_]*)=(.*)$",
                     line.strip())
        if m:
            out[m.group(1)] = _unquote(m.group(2))
    return out


def _quote(v: str) -> str:
    return "'" + str(v).replace("'", "'\\''") + "'"


def _unquote(v: str) -> str:
    v = v.strip()
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1].replace("'\\''", "'")
    return v
