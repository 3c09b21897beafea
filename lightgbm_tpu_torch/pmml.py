"""PMML export (the reference's pmml/pmml.py: a model → PMML 4.2).

A copy of lightgbm_tpu/pmml.py over the port's `Booster.dump_model`:
each tree becomes a `<TreeModel>` segment of a summing `<MiningModel>`,
so one model text loaded into either package exports the same document.
"""
from __future__ import annotations

from typing import List, Optional
from xml.sax.saxutils import quoteattr


def _tree_nodes(node: dict, feature_names: List[str], lines: List[str],
                indent: int, predicate: Optional[str]) -> None:
    pad = "  " * indent
    pred = predicate if predicate is not None else "<True/>"
    if "leaf_index" in node:
        lines.append(f'{pad}<Node id="leaf{node["leaf_index"]}" '
                     f'score="{node["leaf_value"]:.17g}">')
        lines.append(f"{pad}  {pred}")
        lines.append(f"{pad}</Node>")
        return
    feat = quoteattr(feature_names[node["split_feature"]])
    thr = f'{node["threshold"]:.17g}'
    cat = node.get("decision_type") == "is"   # reference JSON type name
    op_l = "equal" if cat else "lessOrEqual"
    op_r = "notEqual" if cat else "greaterThan"
    lines.append(f'{pad}<Node id="split{node["split_index"]}" '
                 f'score="{node.get("internal_value", 0.0):.17g}">')
    lines.append(f"{pad}  {pred}")
    _tree_nodes(node["left_child"], feature_names, lines, indent + 1,
                f'<SimplePredicate field={feat} operator="{op_l}" '
                f'value="{thr}"/>')
    _tree_nodes(node["right_child"], feature_names, lines, indent + 1,
                f'<SimplePredicate field={feat} operator="{op_r}" '
                f'value="{thr}"/>')
    lines.append(f"{pad}</Node>")


def model_to_pmml(booster, model_name: str = "lightgbm_tpu") -> str:
    """PMML document string for a trained Booster / GBDT."""
    gbdt = getattr(booster, "_gbdt", booster)
    model = gbdt.to_json()
    feature_names = list(model["feature_names"])
    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        '<PMML version="4.2" xmlns="http://www.dmg.org/PMML-4_2">',
        f'  <Header description="{model_name}"/>',
        "  <DataDictionary>",
    ]
    for nm in feature_names:
        lines.append(f'    <DataField name={quoteattr(nm)} '
                     'optype="continuous" dataType="double"/>')
    lines.append('    <DataField name="prediction" optype="continuous" '
                 'dataType="double"/>')
    lines.append("  </DataDictionary>")
    lines.append('  <MiningModel functionName="regression" '
                 f'modelName={quoteattr(model_name)}>')
    lines.append("    <MiningSchema>")
    for nm in feature_names:
        lines.append(f'      <MiningField name={quoteattr(nm)}/>')
    lines.append('      <MiningField name="prediction" '
                 'usageType="predicted"/>')
    lines.append("    </MiningSchema>")
    lines.append('    <Segmentation multipleModelMethod="sum">')
    for i, tree in enumerate(model["tree_info"]):
        lines.append(f'      <Segment id="{i + 1}">')
        lines.append("        <True/>")
        lines.append('        <TreeModel functionName="regression" '
                     'splitCharacteristic="binarySplit">')
        lines.append("          <MiningSchema>")
        for nm in feature_names:
            lines.append(f'            <MiningField name={quoteattr(nm)}/>')
        lines.append("          </MiningSchema>")
        _tree_nodes(tree["tree_structure"], feature_names, lines, 5, None)
        lines.append("        </TreeModel>")
        lines.append("      </Segment>")
    lines.append("    </Segmentation>")
    lines.append("  </MiningModel>")
    lines.append("</PMML>")
    return "\n".join(lines)


def save_pmml(booster, filename: str, model_name: str = "lightgbm_tpu"
              ) -> None:
    with open(filename, "w") as f:
        f.write(model_to_pmml(booster, model_name))
