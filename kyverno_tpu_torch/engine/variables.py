"""Variable ``{{...}}`` and relative-reference ``$(...)`` patterns.

Only the two recognisers the policy compiler needs to route a rule whose
pattern holds a variable to the host lane. Substitution itself belongs to
the CPU oracle, which this package does not carry yet.
"""

from __future__ import annotations

import re

REGEX_VARIABLES = re.compile(r"^\{\{[^{}]*\}\}|[^\\]\{\{[^{}]*\}\}")
REGEX_REFERENCES = re.compile(r"^\$\(.[^ ]*\)|[^\\]\$\(.[^ ]*\)")
