"""Tool-call extraction for the TIR domain: the JAX package's
``domains/tir/tool_parser.py`` (Hermes ``<tool_call>{json}</tool_call>``,
the Apriel ``<tool_calls>[...]`` variant, ``[BEGIN FINAL RESPONSE]``
sections, and the streaming parser).

The port keeps one copy of that module, ``inference/tool_parser.py``, which
the server's SSE stream and the fn_calling domain already use; the TIR
domain imports it under the JAX package's name from here.
"""

from ...inference.tool_parser import StreamingToolParser, ToolCall, ToolFunction, parse_tool_calls  # noqa: F401
