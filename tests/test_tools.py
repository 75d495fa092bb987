"""Tool-script contracts: the study scripts must not bitrot."""


def test_int8_study_syntax():
    """tools/int8_study.py stays importable/parseable (it monkey-patches
    render.get_mlp_fn — a study script, but syntax rot would silently
    kill the recorded decision path)."""
    import ast
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "tools" / "int8_study.py")
    ast.parse(src.read_text())
