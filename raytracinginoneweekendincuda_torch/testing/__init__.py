"""Test helpers of the port: the f64 numpy oracle and image comparison."""
