"""Simple INI reader/writer (copy of ``sptag_tpu/utils/ini.py``).

Parity: SPTAG's Helper::IniReader (AnnService/inc/Helper/
SimpleIniReader.h:23-99) — `[Section]` headers, `Key=Value` lines, sections
and keys case-insensitive, `;` comment lines, unknown lines ignored.  Used by
`indexloader.ini`, the Server/Aggregator service configs, and CLI
`Section.Param=Value` passthrough.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple


class IniReader:
    def __init__(self):
        # section(lower) -> { key(lower) -> (original_key, value) }
        self._sections: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._order: Dict[str, str] = {}  # lower -> original section name

    @classmethod
    def loads(cls, text: str) -> "IniReader":
        reader = cls()
        reader._parse(text.splitlines())
        return reader

    @classmethod
    def load(cls, path) -> "IniReader":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            reader = cls()
            reader._parse(f.read().splitlines())
        return reader

    def _parse(self, lines: Iterable[str]) -> None:
        current = ""
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith(";") or line.startswith("#"):
                continue
            if line.startswith("[") and line.endswith("]"):
                current = line[1:-1].strip()
                self._ensure_section(current)
                continue
            eq = line.find("=")
            if eq <= 0:
                continue
            key = line[:eq].strip()
            value = line[eq + 1:].strip()
            self._ensure_section(current)
            self._sections[current.lower()][key.lower()] = (key, value)

    def _ensure_section(self, section: str) -> None:
        low = section.lower()
        if low not in self._sections:
            self._sections[low] = {}
            self._order[low] = section

    def does_section_exist(self, section: str) -> bool:
        return section.lower() in self._sections

    def does_parameter_exist(self, section: str, key: str) -> bool:
        sec = self._sections.get(section.lower())
        return sec is not None and key.lower() in sec

    def get_parameter(self, section: str, key: str,
                      default: Optional[str] = None) -> Optional[str]:
        sec = self._sections.get(section.lower())
        if sec is None:
            return default
        entry = sec.get(key.lower())
        return entry[1] if entry is not None else default

    def set_parameter(self, section: str, key: str, value: str) -> None:
        self._ensure_section(section)
        self._sections[section.lower()][key.lower()] = (key, str(value))

    def section_items(self, section: str) -> Dict[str, str]:
        sec = self._sections.get(section.lower(), {})
        return {orig_key: value for orig_key, value in sec.values()}

    def sections(self):
        return [self._order[k] for k in self._sections]

    def dumps(self) -> str:
        out = []
        for low, sec in self._sections.items():
            name = self._order[low]
            if name:
                out.append(f"[{name}]")
            for orig_key, value in sec.values():
                out.append(f"{orig_key}={value}")
            out.append("")
        return "\n".join(out) + ("\n" if out else "")

    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.dumps())
