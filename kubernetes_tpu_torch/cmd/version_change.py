"""kube-version-change — convert API objects between wire versions
(ref: cmd/kube-version-change/version_change.go: reads an object in any
registered version, writes it in the requested one).

Port of ``kubernetes_tpu/cmd/version_change.py``.

Usage: python -m kubernetes_tpu_torch.cmd.version_change -i in.yaml -o out.json \
           --version v1beta1
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import yaml

__all__ = ["version_change", "main"]


def version_change(argv: List[str],
                   stdin=None, stdout=None) -> int:
    from kubernetes_tpu_torch.api.latest import VERSIONS, scheme

    p = argparse.ArgumentParser(prog="kube-version-change",
                                exit_on_error=False)
    p.add_argument("--input", "-i", default="-")
    p.add_argument("--output", "-o", default="-")
    p.add_argument("--version", "-v", default=scheme.default_version,
                   choices=list(VERSIONS))
    p.add_argument("--format", choices=["json", "yaml"], default="json")
    try:
        opts = p.parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    try:
        if opts.input == "-":
            text = stdin.read()
        else:
            with open(opts.input, "r", encoding="utf-8") as f:
                text = f.read()
        data = yaml.safe_load(text)
        if not isinstance(data, dict):
            raise ValueError("input is not an object manifest")
        wire = scheme.convert_wire(data, data.get("apiVersion", ""),
                                   opts.version)
    except Exception as e:
        print(f"error: unable to convert: {e}", file=sys.stderr)
        return 1
    out = json.dumps(wire, indent=2, sort_keys=True) + "\n" \
        if opts.format == "json" else yaml.safe_dump(wire, sort_keys=True)
    if opts.output == "-":
        stdout.write(out)
    else:
        with open(opts.output, "w", encoding="utf-8") as f:
            f.write(out)
    return 0


def main() -> int:
    return version_change(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
