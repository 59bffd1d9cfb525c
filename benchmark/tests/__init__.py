"""The harness's tests."""
