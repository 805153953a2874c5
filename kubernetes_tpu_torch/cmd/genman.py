"""Generate man pages from the kubectl command tree.

Port of ``kubernetes_tpu/cmd/genman.py``.

ref: cmd/genman/gen_kubectl_man.go — one groff man page per command,
derived from the same live command tree as gendocs (so flags never
drift).

Usage: python -m kubernetes_tpu_torch.cmd.genman [OUTPUT_DIR]
"""

from __future__ import annotations

import sys
from pathlib import Path

from kubernetes_tpu_torch.cmd.gendocs import _options_block, command_tree
from kubernetes_tpu_torch.version import GIT_VERSION

__all__ = ["man_for", "main"]


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace("-", "\\-")


def man_for(name: str, parser, root) -> str:
    title = f"KUBECTL {name.upper()}" if name else "KUBECTL"
    lines = [
        f'.TH "{title}" "1" "" "kubernetes-tpu {GIT_VERSION}" '
        '"User Manuals"',
        ".SH NAME",
        _esc(f"kubectl {name}".strip()) + r" \- "
        + _esc(parser.description or "controls the cluster manager."),
        ".SH SYNOPSIS",
        ".B " + _esc(f"kubectl {name}".strip()),
        r"[\fIOPTIONS\fR]",
        ".SH OPTIONS",
    ]
    for block, src in (("", parser), (" (inherited)", root)):
        if src is parser and block:
            continue  # root page: don't list the same options twice
        opts = _options_block(src)
        if opts:
            for line in opts.splitlines():
                flags, _, rest = line.strip().partition(":")
                lines += [".TP", r"\fB" + _esc(flags) + r"\fR" + block,
                          _esc(rest.strip())]
    lines += [".SH SEE ALSO", ".BR kubectl (1)", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    outdir = Path(args[0] if args else "docs/man")
    outdir.mkdir(parents=True, exist_ok=True)
    root, subs = command_tree()
    (outdir / "kubectl.1").write_text(man_for("", root, root))
    for name, sp in subs.items():
        (outdir / f"kubectl-{name}.1").write_text(man_for(name, sp, root))
    print(f"wrote {len(subs) + 1} man pages to {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
