"""`GiveWay`: what a reader raises where PIL's `_open` for its format raises
`SyntaxError`, `IndexError`, `TypeError`, `KeyError`, `EOFError` or
`struct.error` (PIL's `ImageFile` turns the last four into `SyntaxError`),
on which `Image.open` goes on to the next format in its order.
`io/png.py::read_image` does the same. Called directly, a reader's
`GiveWay` is a `ValueError` that names its cause, like any other."""


class GiveWay(ValueError):
    """The file is not this format as PIL decides it: try the next one."""
