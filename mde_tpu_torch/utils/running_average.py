"""Running means for validation, port of `mde_tpu/utils/running_average.py`
(reference utils.py:56-89)."""


class RunningAverage:
    def __init__(self):
        self.avg = 0.0
        self.count = 0

    def append(self, value):
        self.avg = (float(value) + self.count * self.avg) / (self.count + 1)
        self.count += 1

    def get_value(self):
        return self.avg


class RunningAverageDict:
    def __init__(self):
        self._dict = None

    def update(self, new_dict):
        if self._dict is None:
            self._dict = {key: RunningAverage() for key in new_dict}
        for key, value in new_dict.items():
            self._dict[key].append(value)

    def get_value(self):
        return {key: value.get_value() for key, value in self._dict.items()}
