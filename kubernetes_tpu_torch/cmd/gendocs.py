"""Generate markdown CLI documentation from the kubectl command tree.

Port of ``kubernetes_tpu/cmd/gendocs.py``.

ref: cmd/gendocs/gen_kubectl_docs.go — the reference walks the cobra
command tree and writes one markdown file per command (name, synopsis,
options, parent/child links). Here the tree is the argparse parser that
kubectl itself executes (kubectl/cmd.py _build_parser), so the docs can
never drift from the real flags.

Usage: python -m kubernetes_tpu_torch.cmd.gendocs [OUTPUT_DIR]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kubernetes_tpu_torch.kubectl.cmd import _build_parser

__all__ = ["command_tree", "markdown_for", "main"]


def command_tree():
    """-> (root_parser, {name: subparser}) from the real kubectl tree."""
    root = _build_parser()
    subs = {}
    for action in root._actions:
        if isinstance(action, argparse._SubParsersAction):
            # choices maps aliases too; keep the canonical first names in
            # registration order, folding aliases into one entry
            seen = {}
            for name, sp in action.choices.items():
                if id(sp) not in seen:
                    seen[id(sp)] = (name, sp)
            subs = {name: sp for name, sp in seen.values()}
    return root, subs


def _options_block(parser: argparse.ArgumentParser) -> str:
    lines = []
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction,
                          argparse._SubParsersAction)):
            continue
        flags = ", ".join(a.option_strings) if a.option_strings \
            else a.dest.upper()
        default = "" if a.default in (None, "", False, argparse.SUPPRESS) \
            else f" (default {a.default!r})"
        lines.append(f"      {flags}: {a.help or ''}{default}")
    return "\n".join(lines)


def markdown_for(name: str, parser: argparse.ArgumentParser,
                 root: argparse.ArgumentParser) -> str:
    out = [f"## kubectl {name}", ""]
    if parser.description:
        out += [parser.description, ""]
    opts = _options_block(parser)
    if opts:
        out += ["### Options", "", "```", opts, "```", ""]
    inherited = _options_block(root)
    if inherited:
        out += ["### Options inherited from parent commands", "",
                "```", inherited, "```", ""]
    out += ["### SEE ALSO", "* [kubectl](kubectl.md)", ""]
    return "\n".join(out)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    outdir = Path(args[0] if args else "docs/cli")
    outdir.mkdir(parents=True, exist_ok=True)
    root, subs = command_tree()
    index = ["# kubectl", "",
             root.description or "kubectl controls the cluster manager.",
             "", "### Commands", ""]
    for name, sp in subs.items():
        (outdir / f"kubectl_{name}.md").write_text(
            markdown_for(name, sp, root))
        index.append(f"* [kubectl {name}](kubectl_{name}.md)")
    index.append("")
    (outdir / "kubectl.md").write_text("\n".join(index))
    print(f"wrote {len(subs) + 1} files to {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
