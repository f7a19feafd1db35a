"""Finding records shared by both analysis passes.

A copy of ``repro.analyze.findings`` (framework-neutral), pinned equal to
it by ``tests/test_torch_copies.py``: ``rule`` ids of the runtime audit
start ``audit-``, the lint's are its rule names."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    """One rule violation, locatable and machine-renderable.

    ``rule`` is the stable id (``jaxpr-*`` for pass 1, everything else
    pass 2); ``where`` is ``file:line`` for AST findings and the engine
    variant / closure name for jaxpr findings.
    """

    rule: str
    where: str
    message: str
    severity: str = "error"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "where": self.where,
            "message": self.message,
            "severity": self.severity,
        }

    def __str__(self) -> str:
        return f"{self.where}: [{self.rule}] {self.message}"


@dataclass
class Report:
    """A pass's findings plus what it actually covered (for the CLI)."""

    findings: list[Finding] = field(default_factory=list)
    checked: list[str] = field(default_factory=list)

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.checked.extend(other.checked)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "checked": self.checked,
            "findings": [f.to_dict() for f in self.findings],
        }
