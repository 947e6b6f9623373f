"""Put the repository root on ``sys.path`` when a twin runs as a script
(``python examples_torch/<name>.py``), so that ``import nf_tpu_torch``
and ``import examples_torch._utils`` work. A twin imported as
``examples_torch.<name>`` does not import this module."""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
