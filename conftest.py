import os
import sys

# a time limit for every test, and the table of the JAX reference's
# known defects (tests/_time_limit.py)
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'tests'))
pytest_plugins = ('_time_limit',)
