"""Text and JSON reporters for analyzer findings."""

from __future__ import annotations

import json
from typing import List, Sequence

from .lint import Finding

__all__ = ["render_text", "render_json", "unsuppressed"]


def unsuppressed(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]


def render_text(findings: Sequence[Finding], strict: bool) -> str:
    lines: List[str] = []
    active = unsuppressed(findings)
    for f in findings:
        lines.append(str(f))
    n_sup = len(findings) - len(active)
    lines.append(
        f"repro_torch.analysis: {len(active)} finding(s), "
        f"{n_sup} suppressed"
        + (" [strict]" if strict else "")
    )
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], strict: bool) -> str:
    active = unsuppressed(findings)
    doc = {
        "tool": "repro_torch.analysis",
        "strict": strict,
        "counts": {
            "findings": len(active),
            "suppressed": len(findings) - len(active),
        },
        "findings": [f.to_dict() for f in findings],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
