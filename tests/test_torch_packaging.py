"""Every package of the port is listed in ``pyproject.toml``.

setuptools builds a wheel from the explicit list ``[tool.setuptools]
packages``: a directory of ``bialign_tpu_torch/`` that holds an
``__init__.py`` but is missing from the list is left out of the wheel, and
whatever imports it fails once the port is installed (the tests import it
from the checkout and would not see it).
"""

import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "bialign_tpu_torch"


def _listed() -> list:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["packages"]


def _packages() -> list:
    return sorted(".".join(init.parent.relative_to(ROOT).parts)
                  for init in PORT.rglob("__init__.py"))


@pytest.mark.parametrize("package", _packages())
def test_every_package_of_the_port_is_listed(package):
    assert package in _listed(), (
        f"{package} holds an __init__.py but is missing from "
        "[tool.setuptools] packages in pyproject.toml")


def test_every_listed_package_of_the_port_exists():
    for package in _listed():
        if package.split(".")[0] == "bialign_tpu_torch":
            assert (ROOT.joinpath(*package.split(".")) /
                    "__init__.py").is_file(), package
