"""Text resources → string-constant modules.

≙ translate_text_resource.c (82 LoC): md/txt/json files in a package
become Pony string constants. Here: a module exposing TEXT (and, for
.json, DATA = parsed object) so resources ship inside the package the
same way.
"""

from __future__ import annotations

import json


def translate_text_resource(text: str, *, name: str = "resource.txt") -> str:
    lines = [
        f'"""Resource generated from {name} by ponyc_tpu_torch.translate."""',
        "",
        f"TEXT = {text!r}",
        "",
    ]
    if name.lower().endswith(".json"):
        try:
            json.loads(text)
            lines.extend(["import json", "", "DATA = json.loads(TEXT)", ""])
        except ValueError:
            pass
    return "\n".join(lines)
