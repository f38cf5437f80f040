"""Config template rendering — the docker entrypoint's substitution.

Reference: docker/start-cadence.sh renders docker/config_template.yaml
with dockerize's env templating. Here ``${VAR}`` placeholders are
replaced from the environment; ``*_SEEDS`` variables hold comma lists
of host:port peers and render as quoted YAML flow-sequence items
(unquoted ``host:port`` inside ``[...]`` would parse as a map).

Used by docker/entrypoint.sh (``python -m cadence_tpu.config.render``)
and by the tests that pin the container contract.

A copy of the reference package's ``config/render.py``:
``python -m cadence_tpu_torch.config.render <template> <out>`` renders
the same templates.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Mapping


def render_template(text: str, env: Mapping[str, str]) -> str:
    def value(m: "re.Match[str]") -> str:
        name = m.group(1)
        v = env.get(name, "")
        if name.endswith("_SEEDS"):
            return ", ".join(
                '"%s"' % s.strip() for s in v.split(",") if s.strip()
            )
        return v

    return re.sub(r"\$\{(\w+)\}", value, text)


def main(argv=None) -> None:
    src, dst = (argv or sys.argv[1:])[:2]
    with open(src) as f:
        rendered = render_template(f.read(), os.environ)
    with open(dst, "w") as f:
        f.write(rendered)


if __name__ == "__main__":
    main()
