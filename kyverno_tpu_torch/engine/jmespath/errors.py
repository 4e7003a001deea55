class JMESPathError(ValueError):
    """Base error for parse/eval failures."""


class LexerError(JMESPathError):
    pass


class ParseError(JMESPathError):
    pass


class NotFoundError(JMESPathError):
    """Raised by the engine context when a query returns nothing for a
    required variable (mirrors gojmespath.NotFoundError)."""


class FunctionError(JMESPathError):
    pass
