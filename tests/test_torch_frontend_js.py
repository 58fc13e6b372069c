"""The seven static front-end checks of ``tests/test_frontend_js.py``,
pointed at the port's page, server and backend (``tpu_sdr_torch/gui``).

The checks themselves are the reference tests' functions, called with the
port's page and with the module's ``GUI_DIR`` (which the server- and
backend-source helpers read) set to the port's GUI directory. No JavaScript
engine runs here either."""

import os
import re

import pytest

import test_frontend_js as ref

GUI_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tpu_sdr_torch", "gui")
INDEX = os.path.join(GUI_DIR, "templates", "index.html")


@pytest.fixture(autouse=True)
def port_gui_dir(monkeypatch):
    monkeypatch.setattr(ref, "GUI_DIR", GUI_DIR)
    monkeypatch.setattr(ref, "INDEX", INDEX)


@pytest.fixture(scope="module")
def page() -> str:
    with open(INDEX, encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module")
def script(page: str) -> str:
    """All inline <script> bodies concatenated."""
    blocks = re.findall(r"<script[^>]*>(.*?)</script>", page, re.S)
    assert blocks, "index.html must contain an inline script"
    return "\n".join(blocks)


@pytest.fixture(scope="module")
def markup(page: str) -> str:
    """The page with script bodies removed (the DOM the script sees)."""
    return re.sub(r"<script[^>]*>.*?</script>", "", page, flags=re.S)


def test_sources_are_the_ports():
    assert ref._server_source() == open(os.path.join(GUI_DIR, "server.py")).read()
    assert "tpu_sdr_torch.gui.backend" in ref._backend_source()


def test_script_delimiters_balanced(script):
    ref.test_script_delimiters_balanced(script)


def test_dom_ids_exist(script, markup):
    ref.test_dom_ids_exist(script, markup)


def test_api_routes_dispatched(script):
    ref.test_api_routes_dispatched(script)


def test_sse_events_wired_both_ways(script):
    ref.test_sse_events_wired_both_ways(script)


def test_every_button_is_wired(script, markup):
    ref.test_every_button_is_wired(script, markup)


def test_designer_payload_keys_match_backend(script):
    ref.test_designer_payload_keys_match_backend(script)


def test_sse_payload_fields_exist_in_backend(script):
    ref.test_sse_payload_fields_exist_in_backend(script)
