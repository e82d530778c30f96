"""K6, the cluster dispatch: its plain version against the JAX package's kernel
in interpret mode and the port's dense hit, and the ``Renderer`` with
``intersector="cluster"``. The cases, shared by the three dispatch
intersectors, are in tests/torch_dispatch_cases.py with their tolerances.
"""

import pytest

pytest.register_assert_rewrite("tests.torch_dispatch_cases")

from tests.torch_dispatch_cases import *  # noqa: E402,F401,F403


@pytest.fixture
def kind():
    return "cluster"
