"""Small shared utilities: doc copying, as xdem_tpu/_misc.py has it."""

from __future__ import annotations

from typing import Any, Callable, TypeVar

T = TypeVar("T")


def copy_doc(module: Any, name: str | None = None) -> Callable[[Callable[..., T]], Callable[..., T]]:
    """Copy the docstring of `module.<name>` onto the decorated function/method."""

    def decorator(func: Callable[..., T]) -> Callable[..., T]:
        source = getattr(module, name or func.__name__, None)
        if source is not None and source.__doc__:
            func.__doc__ = source.__doc__
        return func

    return decorator
