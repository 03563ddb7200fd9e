"""Small helpers of the port that import neither torch nor numpy:
``wire_json``, the escape-aware JSON codec of the isolation boundary."""
