"""JSON Schema → typed Python classes (and actor field specs).

≙ translate_json_schema.c (1182 LoC): the fork turns `.schema.json`
files in a package into Pony classes with typed fields and JSON
(de)serialisation. The Python twin emits dataclasses with from_dict/
to_dict/from_json/to_json, nested object/array support, and — the
framework's own addition — an `ACTOR_FIELDS` table mapping flat int/number/
boolean properties to this framework's I32/F32/Bool field annotations so
a schema can seed a device actor type's state layout.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


def _class_name(s: str) -> str:
    parts = [p for p in
             s.replace("-", " ").replace("_", " ").replace(".", " ").split()]
    return "".join(p.capitalize() for p in parts) or "Root"


def _py_type(prop: Dict[str, Any], name: str,
             classes: List[str]) -> str:
    t = prop.get("type")
    if t == "string":
        return "str"
    if t == "integer":
        return "int"
    if t == "number":
        return "float"
    if t == "boolean":
        return "bool"
    if t == "array":
        inner = _py_type(prop.get("items", {}), name + "Item", classes)
        return f"List[{inner}]"
    if t == "object" or "properties" in prop:
        cname = _class_name(prop.get("title", name))
        _emit_class(cname, prop, classes)
        return cname
    return "Any"


def _default_for(tp: str) -> str:
    return {"str": '""', "int": "0", "float": "0.0", "bool": "False"}.get(
        tp, "None" if not tp.startswith("List[") else
        "field(default_factory=list)")


def _emit_class(cname: str, schema: Dict[str, Any],
                classes: List[str]) -> None:
    props = schema.get("properties", {})
    required = set(schema.get("required", []))
    lines = ["@dataclass", f"class {cname}:"]
    doc = schema.get("description")
    if doc:
        lines.append(f'    """{doc}"""')
    field_lines = []
    conv_from = []
    conv_to = []
    actor_fields = []
    for pname, prop in props.items():
        tp = _py_type(prop, _class_name(pname), classes)
        dflt = "" if pname in required else f" = {_default_for(tp)}"
        field_lines.append(f"    {pname}: {tp}{dflt}")
        if tp in ("int", "bool", "float"):
            spec = {"int": "I32", "bool": "Bool", "float": "F32"}[tp]
            actor_fields.append(f'        "{pname}": {spec!r},')
        if tp in ("str", "int", "float", "bool", "Any"):
            conv_from.append(
                f'            {pname}=d.get("{pname}"'
                + (")" if pname in required
                   else f", {_default_for(tp)})"))
            conv_to.append(f'            "{pname}": self.{pname},')
        elif tp.startswith("List["):
            inner = tp[5:-1]
            if inner in ("str", "int", "float", "bool", "Any"):
                conv_from.append(
                    f'            {pname}=list(d.get("{pname}", [])),')
                conv_to.append(f'            "{pname}": '
                               f"list(self.{pname}),")
            else:
                conv_from.append(
                    f'            {pname}=[{inner}.from_dict(x) '
                    f'for x in d.get("{pname}", [])],')
                conv_to.append(f'            "{pname}": '
                               f"[x.to_dict() for x in self.{pname}],")
        else:
            conv_from.append(
                f'            {pname}={tp}.from_dict('
                f'd.get("{pname}", {{}})),')
            conv_to.append(f'            "{pname}": '
                           f"self.{pname}.to_dict(),")
    if not field_lines:
        field_lines.append("    pass")
    lines.extend(field_lines)
    # fix missing comma normalisation for required scalars
    conv_from = [c if c.endswith(",") else c + "," for c in conv_from]
    lines.append("")
    lines.append("    @classmethod")
    lines.append("    def from_dict(cls, d):")
    lines.append(f"        return cls(")
    lines.extend(conv_from)
    lines.append("        )")
    lines.append("")
    lines.append("    def to_dict(self):")
    lines.append("        return {")
    lines.extend(conv_to)
    lines.append("        }")
    lines.append("")
    lines.append("    @classmethod")
    lines.append("    def from_json(cls, text):")
    lines.append("        return cls.from_dict(json.loads(text))")
    lines.append("")
    lines.append("    def to_json(self):")
    lines.append("        return json.dumps(self.to_dict())")
    if actor_fields:
        lines.append("")
        lines.append("    # flat scalar fields usable as device-actor")
        lines.append("    # state specs (ponyc_tpu_torch I32/F32/Bool):")
        lines.append("    ACTOR_FIELDS = {")
        lines.extend(actor_fields)
        lines.append("    }")
    classes.append("\n".join(lines))


def translate_json_schema(text: str, *, name: str = "x.schema.json") -> str:
    schema = json.loads(text)
    classes: List[str] = []
    root = _class_name(schema.get("title", name.split(".")[0]))
    _emit_class(root, schema, classes)
    header = [
        f'"""Classes generated from {name} by ponyc_tpu_torch.translate."""',
        "",
        "import json",
        "from dataclasses import dataclass, field",
        "from typing import Any, List",
        "",
        "",
    ]
    return "\n".join(header) + "\n\n\n".join(classes) + "\n"
